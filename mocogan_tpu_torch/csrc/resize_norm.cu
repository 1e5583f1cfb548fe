// Fused ingest of the device-cached training path, one launch per step:
//   temporal gather from the resident uint8 clip pool
//   -> separable 2-tap bilinear resize
//   -> affine to [-1, 1], written (B, T, S, S, C) float32.
//
// Replaces the TPU kernel mocogan_tpu/ops/preproc.py::_resize_norm_kernel
// (launched by _resize_normalize_planes_pallas, pl.pallas_call at :90),
// which computed Z = R_h X R_w per pre-gathered, pre-transposed (H, W)
// plane; the gather and the layout change are folded in here.
//
// Bound on an H100 SXM at the mug shape (B 16, T 16, C 3, 96 -> 64 px):
// 7.08 MB of uint8 read + 12.58 MB of float32 written is ~5.9 us at
// 3.35 TB/s; bilinear needs 2 taps per output of each pass, 0.038 GFLOP
// (~0.6 us at 67 TFLOP/s fp32), so the function is bound by bytes.
//
// Design, against what held the first (dense, one block per plane)
// version back:
// - Dense arithmetic: each row of R_h and R_w has at most two adjacent
//   non-zero weights, so the kernel takes them as tap tables
//   (ops/preproc.py::resize_taps, indices and weights taken from the same
//   bilinear matrix) and spends 4 taps per output, not H + W.
// - One block per (b, t, c) plane, gathering its channel at stride C: a
//   block now takes a (frame, band of output rows) with all C channels,
//   since a frame's HWC rows are contiguous. It stages the input rows its
//   band reads (24 of 96 for 16 output rows at mug) in shared memory with
//   16-byte loads, so each byte of the frame crosses from device memory
//   once, in full sectors; a byte-load branch of the same kernel takes a
//   row block that is not 16-byte aligned.
// - Strided stores: a band's output rows are one contiguous run of
//   rows x S x C floats. A warp makes one row, lane j the outputs j,
//   j + 32, ..., so every store instruction writes 128 contiguous bytes,
//   full lines as float4 stores would. This mapping (not 4 consecutive
//   outputs a thread) keeps each warp-wide byte read inside a few words of
//   one staged row, one shared-memory wavefront, and the row's taps
//   warp-uniform: with 4 consecutive outputs a thread, each warp-wide
//   byte read spans ~190 bytes (two wavefronts), and shared-memory traffic
//   rather than device memory set the kernel's time.
// - Phases: one barrier per block, after the staging. A block holds ~8 KB
//   of shared memory at mug and is held to 32 registers a thread, so
//   8 blocks share an SM and the 1024 blocks of the mug shape are all
//   resident at once. Their loads and their stores still run mostly in
//   sequence; overlapping them (double-buffered bands) is left open.
// Sums are IEEE fp32 FMAs (no fast math, no TF32), the vertical pass first
// as in the plain version, so the two agree to rounding. An out-of-range
// clip or frame index fills its band with NaN instead of reading out of
// bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 8 blocks of 256 threads fill an SM's 2048 threads; this caps a thread at
// 32 registers.
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    resize_norm_gather_kernel(const uint8_t* __restrict__ pool,
                              const int32_t* __restrict__ clip_ix,
                              const int32_t* __restrict__ frame_ix,
                              const int32_t* __restrict__ idx,
                              const float* __restrict__ wts,
                              float* __restrict__ out, int n_clips, int t_max,
                              int T, int H, int W, int C, int S, int band,
                              int n_bands, float scale, float offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [col: S int4 | row: band int4 | staged input rows]. col[v] holds output
  // column v's two tap byte offsets and weights; row[sl] band row sl's two
  // tap row byte offsets (into the staged rows) and weights.
  int4* col = reinterpret_cast<int4*>(smem);
  int4* row = col + S;
  uint8_t* x = reinterpret_cast<uint8_t*>(row + band);

  const int f = blockIdx.x / n_bands;  // frame: b * T + t
  const int s0 = (blockIdx.x % n_bands) * band;
  const int rows = min(band, S - s0);
  const int line = S * C;  // floats per output row
  float* dst = out + (static_cast<size_t>(f) * S + s0) * line;

  // idx rows: ih0, ih1, iw0, iw1; wts rows: wh0, wh1, ww0, ww1 (each S).
  // Row taps are non-decreasing in s, so the band reads input rows
  // [ih0[s0], ih1[s0 + rows - 1]] and no others. The loads that do not
  // depend on each other are issued together, before the tables are
  // staged, so that their latencies overlap.
  const int clip = __ldg(clip_ix + f / T);
  const int frame = __ldg(frame_ix + f);
  const int r0 = __ldg(idx + s0);
  const int in_line = W * C;  // bytes per input row
  const int n_in = (__ldg(idx + S + s0 + rows - 1) - r0 + 1) * in_line;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    col[i] = make_int4(__ldg(idx + 2 * S + i) * C, __ldg(idx + 3 * S + i) * C,
                       __float_as_int(__ldg(wts + 2 * S + i)),
                       __float_as_int(__ldg(wts + 3 * S + i)));
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    row[i] = make_int4((__ldg(idx + s0 + i) - r0) * in_line,
                       (__ldg(idx + S + s0 + i) - r0) * in_line,
                       __float_as_int(__ldg(wts + s0 + i)),
                       __float_as_int(__ldg(wts + S + s0 + i)));
  if (clip < 0 || clip >= n_clips || frame < 0 || frame >= t_max) {
    const float nan = __int_as_float(0x7fc00000);
    for (int e = threadIdx.x; e < rows * line; e += blockDim.x) dst[e] = nan;
    return;
  }

  const uint8_t* src =
      pool + ((static_cast<size_t>(clip) * t_max + frame) * H + r0) * in_line;
  int staged = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* x4 = reinterpret_cast<uint4*>(x);
    for (int i = threadIdx.x; i < n_in / 16; i += blockDim.x)
      x4[i] = __ldg(s4 + i);
    staged = n_in & ~15;
  }
  for (int i = staged + threadIdx.x; i < n_in; i += blockDim.x)
    x[i] = __ldg(src + i);
  __syncthreads();

  // A warp per band row; lane j makes outputs j, j + 32, ... of the row,
  // stepping its (column v, channel c) without a division.
  const int lane = threadIdx.x % 32;
  const int dv = 32 / C, dc = 32 % C;
  for (int sl = threadIdx.x / 32; sl < rows; sl += blockDim.x / 32) {
    const int4 r = row[sl];
    const uint8_t* a = x + r.x;
    const uint8_t* b = x + r.y;
    const float wa = __int_as_float(r.z), wb = __int_as_float(r.w);
    float* o = dst + sl * line;
    int v = lane / C, c = lane % C;
    for (int i = lane; i < line; i += 32) {
      const int4 k = col[v];
      // the vertical pass first, as the plain version does
      const float y0 = fmaf(wb, static_cast<float>(b[k.x + c]),
                            wa * static_cast<float>(a[k.x + c]));
      const float y1 = fmaf(wb, static_cast<float>(b[k.y + c]),
                            wa * static_cast<float>(a[k.y + c]));
      const float z =
          fmaf(__int_as_float(k.w), y1, __int_as_float(k.z) * y0);
      o[i] = fmaf(z, scale, offset);
      c += dc;
      v += dv;
      if (c >= C) {
        c -= C;
        ++v;
      }
    }
  }
}

}  // namespace

// pool (n_clips, t_max, H, W, C) uint8; clip_ix (B,) int32;
// frame_ix (B, T) int32; idx (4, S) int32 and wts (4, S) float32, the tap
// tables of ops/preproc.py::resize_taps; out (B, T, S, S, C) float32. All
// contiguous on one device. `band` output rows per block, `span` the most
// input rows any band reads. Launched on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int resize_norm_gather(const void* pool, const void* clip_ix,
                                  const void* frame_ix, const void* idx,
                                  const void* wts, void* out, int B, int T,
                                  int n_clips, int t_max, int H, int W, int C,
                                  int S, int band, int span, void* stream) {
  const size_t smem =
      16 * static_cast<size_t>(S + band) + static_cast<size_t>(span) * W * C;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resize_norm_gather_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_bands = (S + band - 1) / band;
  const int blocks = B * T * n_bands;
  if (blocks == 0) return 0;
  resize_norm_gather_kernel<<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(clip_ix),
      static_cast<const int32_t*>(frame_ix), static_cast<const int32_t*>(idx),
      static_cast<const float*>(wts), static_cast<float*>(out), n_clips, t_max,
      T, H, W, C, S, band, n_bands, 2.0f / 255.0f, -1.0f);
  return static_cast<int>(cudaGetLastError());
}
