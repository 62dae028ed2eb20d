// Profile-DP fill and backtrack for Hopper (sm_90a), called from JAX
// through the XLA FFI.
//
// The gap-closing recurrence of dynamicprogramming.c:993-1026 (NW of one
// sequence against the column-count profile; tie-break diag > left > up)
// for a batch of G independent gaps.  Layout contract and the plain-JAX
// twin of this kernel: csa_jax/dp/profile_cuda.py.
//
// Work split: one warp per (gap, strip of kStrip DP columns); lane t owns
// kCols consecutive columns of the strip and walks the rows skewed by one
// step per lane (lane t computes row j at step j - 1 + t), so the left
// neighbour's last column for the same row arrives by one warp shuffle
// and every lane works on every step.  Strips of one gap run as separate
// blocks: the last lane publishes its column to `bnd` and releases a
// per-strip row counter every kPublish rows; lane 0 of the next strip
// acquires it before reading.  Blocks take a ticket from a global counter
// in launch order, so a strip only ever waits on a strip that is already
// running.
//
// Values live in the x4 priority domain: every carried score is 4*score;
// the three arms add constants carrying 2 (diag), 1 (left) or 0 (up) in
// the low two bits, so one max implements the tie-break, `& 3` is the
// direction and `& ~3` the clean value.  Directions are stored 2 bits per
// cell, kCols cells per 16-bit word, indexed [gap][strip][step][lane].

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kCols = 8;               // DP columns per lane
constexpr int kStrip = kWarp * kCols;  // DP columns per warp
constexpr int kPublish = 32;           // rows between counter releases
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int LoadAcquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void StoreRelease(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// codes (G, rp) int8; svpack/rest/cgap (G, cp) int32; top (G, cp + 1)
// int32; scal (G, 4) int32 = [4*rowgap, 4*edge_rowgap, R, C].
// dirs (G, cp / kStrip, rp + kWarp, kWarp) uint16; bnd (G * cp / kStrip,
// rp + 1) int32; flags (G * cp / kStrip + 1) int32, zeroed, last = ticket.
__global__ void __launch_bounds__(kWarp)
ProfileFillKernel(const int8_t* __restrict__ codes,
                  const int32_t* __restrict__ svpack,
                  const int32_t* __restrict__ rest,
                  const int32_t* __restrict__ cgap,
                  const int32_t* __restrict__ top,
                  const int32_t* __restrict__ scal, int a4, int rp, int cp,
                  int nstrips, uint16_t* __restrict__ dirs, int32_t* bnd,
                  int32_t* flags) {
  __shared__ int ticket;
  const int lane = threadIdx.x;
  if (lane == 0) ticket = atomicAdd(flags + gridDim.x, 1);
  __syncthreads();
  const int g = ticket / nstrips;
  const int k = ticket - g * nstrips;
  const int rowgap4 = scal[4 * g];
  const int erg4 = scal[4 * g + 1];
  const int R = scal[4 * g + 2];
  const int C = scal[4 * g + 3];
  if (k * kStrip >= C) return;  // strip right of every real column

  const int col0 = k * kStrip + lane * kCols;  // profile column of DP col col0+1
  const int32_t* topg = top + static_cast<size_t>(g) * (cp + 1);
  const size_t off = static_cast<size_t>(g) * cp + col0;
  int pk[kCols], rs[kCols], cg[kCols], prev[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    pk[q] = svpack[off + q];
    rs[q] = rest[off + q];
    cg[q] = cgap[off + q];
    prev[q] = topg[col0 + q + 1];
  }

  const size_t strip = static_cast<size_t>(g) * nstrips + k;
  const size_t lstrip = k > 0 ? strip - 1 : strip;  // read only if k > 0
  const int32_t* lbnd = bnd + lstrip * (rp + 1);
  int32_t* rbnd = bnd + strip * (rp + 1);
  const int* lflag = flags + lstrip;
  int* rflag = flags + strip;
  uint16_t* out = dirs + strip * (rp + kWarp) * kWarp + lane;
  const int8_t* rowcodes = codes + static_cast<size_t>(g) * rp;

  // dp[j-1][col0]: the diag operand of the lane's first column
  int diag_in = __shfl_up_sync(kFull, prev[kCols - 1], 1);
  if (lane == 0) diag_in = topg[col0];
  if (lane == kWarp - 1) rbnd[0] = prev[kCols - 1];
  int ready = 0;
  const int nsteps = R + kWarp - 1;
  for (int s = 0; s < nsteps; ++s) {
    const int j = s - lane + 1;
    const bool active = j >= 1 && j <= R;
    // 7-bit count field of the row's base; 28 (the pad code 4) reads 0
    const int sh = active ? 7 * rowcodes[j - 1] : 28;
    // dp[j][col0]: the left neighbour finished row j on the last step
    int left = __shfl_up_sync(kFull, prev[kCols - 1], 1);
    if (lane == 0 && active) {
      if (k == 0) {
        left = j * erg4;
      } else {
        if (j > ready) {
          while ((ready = LoadAcquire(lflag)) < j) __nanosleep(32);
        }
        left = __ldcg(lbnd + j);
      }
    }
    int diag = diag_in;
    diag_in = left;
    if (active) {
      unsigned word = 0;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int cnt = (pk[q] >> sh) & 127;
        const int m = max(diag + a4 * cnt + rs[q], prev[q] + rowgap4);
        const int vp = max(m, left + cg[q]);
        word |= static_cast<unsigned>(vp & 3) << (2 * q);
        diag = prev[q];
        left = vp & ~3;
        prev[q] = left;
      }
      out[static_cast<size_t>(s) * kWarp] = static_cast<uint16_t>(word);
      if (lane == kWarp - 1) {
        rbnd[j] = left;
        if (j % kPublish == 0 || j == R) StoreRelease(rflag, j);
      }
    }
  }
}

// One thread per gap walks its packed directions from (R, C) to (0, 0):
// main region by direction code, then the j > 0 / c > 0 edge runs (the
// reference backtrack order, dynamicprogramming.c:1032-1138).  Writes the
// walk-order codes (0 diag, 1 left, 2 up) to path (G, L) and the step
// count to nsteps (G).
__global__ void BacktrackKernel(const uint16_t* __restrict__ dirs,
                                const int32_t* __restrict__ scal, int G,
                                int rp, int nstrips, int L,
                                int8_t* __restrict__ path,
                                int32_t* __restrict__ nsteps) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int j = scal[4 * g + 2];
  int c = scal[4 * g + 3];
  const uint16_t* d = dirs + static_cast<size_t>(g) * nstrips * (rp + kWarp) *
                                 kWarp;
  int8_t* out = path + static_cast<size_t>(g) * L;
  int t = 0;
  while (j > 0 || c > 0) {
    int code;
    if (j > 0 && c > 0) {
      const int q = c - 1;
      const int lane = (q / kCols) % kWarp;
      const size_t step = static_cast<size_t>(q / kStrip) * (rp + kWarp) +
                          (j - 1 + lane);
      code = 2 - ((d[step * kWarp + lane] >> (2 * (q % kCols))) & 3);
    } else {
      code = j > 0 ? 2 : 1;
    }
    out[t++] = static_cast<int8_t>(code);
    if (code != 1) --j;
    if (code != 2) --c;
  }
  nsteps[g] = t;
}

ffi::Error ProfilePathsImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> codes,
                            ffi::Buffer<ffi::S32> svpack,
                            ffi::Buffer<ffi::S32> rest,
                            ffi::Buffer<ffi::S32> cgap,
                            ffi::Buffer<ffi::S32> top,
                            ffi::Buffer<ffi::S32> scal, int32_t a4,
                            ffi::ResultBuffer<ffi::S8> path,
                            ffi::ResultBuffer<ffi::S32> nsteps,
                            ffi::ResultBuffer<ffi::U16> dirs,
                            ffi::ResultBuffer<ffi::S32> bnd,
                            ffi::ResultBuffer<ffi::S32> flags) {
  const auto cd = codes.dimensions();
  const auto sd = svpack.dimensions();
  if (cd.size() != 2 || sd.size() != 2 || cd[0] != sd[0]) {
    return ffi::Error::InvalidArgument("codes (G, R) and svpack (G, C)");
  }
  const int64_t G = cd[0], rp = cd[1], cp = sd[1];
  if (cp % kStrip != 0) {
    return ffi::Error::InvalidArgument("padded column count % 256 != 0");
  }
  const int64_t nstrips = cp / kStrip;
  const int64_t nblocks = G * nstrips;
  const int64_t L = rp + cp;
  if (path->element_count() != static_cast<size_t>(G * L) ||
      nsteps->element_count() != static_cast<size_t>(G) ||
      flags->element_count() != static_cast<size_t>(nblocks + 1) ||
      dirs->element_count() !=
          static_cast<size_t>(nblocks * (rp + kWarp) * kWarp) ||
      bnd->element_count() != static_cast<size_t>(nblocks * (rp + 1))) {
    return ffi::Error::InvalidArgument("result shapes do not match inputs");
  }
  cudaMemsetAsync(flags->typed_data(), 0, (nblocks + 1) * sizeof(int32_t),
                  stream);
  if (nblocks > 0) {
    ProfileFillKernel<<<static_cast<unsigned>(nblocks), kWarp, 0, stream>>>(
        codes.typed_data(), svpack.typed_data(), rest.typed_data(),
        cgap.typed_data(), top.typed_data(), scal.typed_data(), a4,
        static_cast<int>(rp), static_cast<int>(cp),
        static_cast<int>(nstrips), dirs->typed_data(), bnd->typed_data(),
        flags->typed_data());
  }
  if (G > 0) {
    BacktrackKernel<<<static_cast<unsigned>((G + kWarp - 1) / kWarp), kWarp,
                      0, stream>>>(
        dirs->typed_data(), scal.typed_data(), static_cast<int>(G),
        static_cast<int>(rp), static_cast<int>(nstrips),
        static_cast<int>(L), path->typed_data(), nsteps->typed_data());
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CsaProfilePaths, ProfilePathsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("a4")
                                  .Ret<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U16>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
