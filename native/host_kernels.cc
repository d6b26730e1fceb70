// Host build of the GPU kernels (gpu_kernels.h): the same arithmetic
// the GPU runs, looped over lanes on the CPU, so the CPU tests check the
// kernels' results (cuda_kernels.py::host_point_op / host_field_op).
#include "gpu_kernels.h"

template <class F>
static void field_lanes(int op, int64_t m, const uint32_t* a, const uint32_t* b,
                        uint32_t* o) {
  for (int64_t i = 0; i < m; ++i) {
    if (op == sczk::F_MUL) sczk::field_op_lane<F, sczk::F_MUL>(a, b, o, i);
    else if (op == sczk::F_ADD) sczk::field_op_lane<F, sczk::F_ADD>(a, b, o, i);
    else sczk::field_op_lane<F, sczk::F_SUB>(a, b, o, i);
  }
}

// field: 0 = BLS12-381 Fr, 1 = BLS12-381 Fq (as SczkFieldOp)
extern "C" void sczk_field_host(int field, int op, int64_t m, const uint32_t* a,
                                const uint32_t* b, uint32_t* o) {
  if (field == 0) field_lanes<sczk::Fr381>(op, m, a, b, o);
  else field_lanes<sczk::Fq381>(op, m, a, b, o);
}

extern "C" void sczk_g1_point_host(int op, int64_t m, const uint32_t* const* in,
                                   const uint32_t* mask, uint32_t* const* out,
                                   uint32_t* flag) {
  sczk::Args a;
  for (int k = 0; k < 6; ++k) a.in[k] = in[k];
  for (int k = 0; k < 3; ++k) a.out[k] = out[k];
  a.mask = mask;
  a.flag = flag;
  a.m = m;
  for (int64_t i = 0; i < m; ++i) {
    switch (op) {
      case sczk::OP_ADD: sczk::point_op_lane<sczk::OP_ADD>(a, i); break;
      case sczk::OP_ADD_MIXED: sczk::point_op_lane<sczk::OP_ADD_MIXED>(a, i); break;
      case sczk::OP_DOUBLE: sczk::point_op_lane<sczk::OP_DOUBLE>(a, i); break;
      case sczk::OP_ADD_MASKED: sczk::point_op_lane<sczk::OP_ADD_MASKED>(a, i); break;
      case sczk::OP_ADD_RESET: sczk::point_op_lane<sczk::OP_ADD_RESET>(a, i); break;
      default: sczk::point_op_lane<sczk::OP_ADD_RESET_LAZY>(a, i); break;
    }
  }
}
