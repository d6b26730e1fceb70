// BLS12-381 GPU kernels called from JAX through the XLA FFI
// (cuda_kernels.py): elementwise Fr / Fq multiply, add and subtract, and
// the fused G1 point ops.  One thread per element / point; the arithmetic
// is in gpu_kernels.h.  Build (sm_90a, by cuda_kernels.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
//        -Xcompiler -fPIC -I$(python -c 'import jax.ffi; print(jax.ffi.include_dir())') \
//        -o build/libsczkcuda.so gpu_kernels.cu
#include <cuda_runtime.h>

#include "gpu_kernels.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

constexpr int THREADS = 128;

template <int OP>
__global__ void __launch_bounds__(THREADS) g1_kernel(sczk::Args a) {
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < a.m) sczk::point_op_lane<OP>(a, i);
}

static ffi::Error G1PointImpl(cudaStream_t stream,
                              ffi::Buffer<ffi::U32> x1, ffi::Buffer<ffi::U32> y1,
                              ffi::Buffer<ffi::U32> z1, ffi::Buffer<ffi::U32> x2,
                              ffi::Buffer<ffi::U32> y2, ffi::Buffer<ffi::U32> z2,
                              ffi::Buffer<ffi::U32> mask,
                              ffi::ResultBuffer<ffi::U32> ox,
                              ffi::ResultBuffer<ffi::U32> oy,
                              ffi::ResultBuffer<ffi::U32> oz,
                              ffi::ResultBuffer<ffi::U32> oflag, int32_t op) {
  sczk::Args a;
  a.in[0] = x1.typed_data();
  a.in[1] = y1.typed_data();
  a.in[2] = z1.typed_data();
  a.in[3] = x2.typed_data();
  a.in[4] = y2.typed_data();
  a.in[5] = z2.typed_data();
  a.mask = mask.typed_data();
  a.out[0] = ox->typed_data();
  a.out[1] = oy->typed_data();
  a.out[2] = oz->typed_data();
  a.flag = oflag->typed_data();
  a.m = (int64_t)mask.element_count();
  if (x1.element_count() != (size_t)a.m * 4 * sczk::Fq381::NW)
    return ffi::Error::InvalidArgument("coordinates must be [M, 24] uint32");
  if (a.m == 0) return ffi::Error::Success();
  int64_t blocks = (a.m + THREADS - 1) / THREADS;
  switch (op) {
    case sczk::OP_ADD: g1_kernel<sczk::OP_ADD><<<blocks, THREADS, 0, stream>>>(a); break;
    case sczk::OP_ADD_MIXED: g1_kernel<sczk::OP_ADD_MIXED><<<blocks, THREADS, 0, stream>>>(a); break;
    case sczk::OP_DOUBLE: g1_kernel<sczk::OP_DOUBLE><<<blocks, THREADS, 0, stream>>>(a); break;
    case sczk::OP_ADD_MASKED: g1_kernel<sczk::OP_ADD_MASKED><<<blocks, THREADS, 0, stream>>>(a); break;
    case sczk::OP_ADD_RESET: g1_kernel<sczk::OP_ADD_RESET><<<blocks, THREADS, 0, stream>>>(a); break;
    case sczk::OP_ADD_RESET_LAZY: g1_kernel<sczk::OP_ADD_RESET_LAZY><<<blocks, THREADS, 0, stream>>>(a); break;
    default: return ffi::Error::InvalidArgument("unknown point op");
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

template <class F, int OP>
__global__ void __launch_bounds__(THREADS)
    field_kernel(const uint32_t* a, const uint32_t* b, uint32_t* o, int64_t m) {
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < m) sczk::field_op_lane<F, OP>(a, b, o, i);
}

template <class F>
static ffi::Error LaunchField(cudaStream_t stream, int32_t op, const uint32_t* a,
                              const uint32_t* b, uint32_t* o, size_t n) {
  if (n % (4 * F::NW)) return ffi::Error::InvalidArgument("bad limb count");
  int64_t m = (int64_t)(n / (4 * F::NW));
  if (m == 0) return ffi::Error::Success();
  int64_t blocks = (m + THREADS - 1) / THREADS;
  switch (op) {
    case sczk::F_MUL: field_kernel<F, sczk::F_MUL><<<blocks, THREADS, 0, stream>>>(a, b, o, m); break;
    case sczk::F_ADD: field_kernel<F, sczk::F_ADD><<<blocks, THREADS, 0, stream>>>(a, b, o, m); break;
    case sczk::F_SUB: field_kernel<F, sczk::F_SUB><<<blocks, THREADS, 0, stream>>>(a, b, o, m); break;
    default: return ffi::Error::InvalidArgument("unknown field op");
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

// field: 0 = BLS12-381 Fr, 1 = BLS12-381 Fq;  op: sczk::FieldOp
static ffi::Error FieldOpImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a,
                              ffi::Buffer<ffi::U32> b,
                              ffi::ResultBuffer<ffi::U32> out, int32_t field,
                              int32_t op) {
  size_t n = out->element_count();
  if (a.element_count() != n || b.element_count() != n)
    return ffi::Error::InvalidArgument("operands must have the output's shape");
  if (field == 0)
    return LaunchField<sczk::Fr381>(stream, op, a.typed_data(), b.typed_data(),
                                    out->typed_data(), n);
  if (field == 1)
    return LaunchField<sczk::Fq381>(stream, op, a.typed_data(), b.typed_data(),
                                    out->typed_data(), n);
  return ffi::Error::InvalidArgument("unknown field");
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkFieldOp, FieldOpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("field")
                                  .Attr<int32_t>("op"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(SczkG1Point, G1PointImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("op"));
