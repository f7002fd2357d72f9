// Kernel 1's PotentialCtrl form (rollout.cuh, kPotentialEm): the EM rollout of
// SubtrajBridge's control (solver=dis_subtraj, bridge_subtraj), for every d.
//
// It replaces the TPU kernel `fused_sim_rollout` with `sde_step_fn`
// (sde_sampler_tpu/ops/rollout_pallas.py:68, pallas_call at :202, step at
// :214) traced over `PotentialCtrl.__call__`
// (sde_sampler_tpu/models/reparam.py:164-179), whose control is the gradient
// of a scalar net:
//
//   u = diff[k] * grad_x clip(net(s, x), clip_model),
//   x' = x + (drift[k] * x + diff[k] * u) * dt[k] + diff[k] * db[k].
//
// So every EM step runs the FourierMLP (C channels, H hidden layers, a C -> 1
// out_layer) forward, keeping its pre-activations, then its backward pass to
// the state:
//
//   h_0 = W_in x + temb[k], h_{l+1} = W_l gelu(h_l) + b_l, net = w_out . gelu(h_H) + b_out,
//   delta_H = w_out * gelu'(h_H), delta_l = (W_l^T delta_{l+1}) * gelu'(h_l),
//   grad_x = m W_in^T delta_0, m = 1{|net| <= clip_model}
//
// (the clip's gradient is 0 where |net| > clip_model, as jnp.clip's), with
// gelu'(z) = (1 + erf(z / sqrt 2)) / 2 + z exp(-z^2 / 2) / sqrt(2 pi). The
// per-step tables are those of the other forms (rollout.cuh): the time
// embedding (T, C) and the step's drift, diffusion and dt; the score columns
// are unused.
//
// Bound on an H100: operations. The backward repeats the forward's
// multiply-adds (C d + H C^2 per row and step) and adds a GELU derivative per
// activation, about twice the arithmetic of the ClippedCtrl form; the bytes
// moved are the same (noise in, states out).
//
// Both bodies stage every weight in shared memory in its (in, out) layout,
// rows padded to pad4(C) + 4 floats: the backward's transposed products
// W_l^T delta and the gradient W_in^T delta_0 read those rows as float4s
// along c, which the padding keeps conflict-free in each quarter-warp phase
// (tile_fma_nt, grad_tile), so the backward needs no transposed copy.
//
// Sum orders, shared by every body, so that they give the same bits where
// both run (C = 64, H = 2, d <= 16):
// - the forward's sums from their bias (the time embedding for h_0), over
//   their input ascending, by fmaf;
// - the backward's from 0, over c ascending, by fmaf;
// - the net of a row: the products w_out[c] gelu(h_H)[c] rounded on their
//   own, summed over each 32 channels by a xor butterfly (lane distances 16,
//   8, 4, 2, 1), the two halves added, then b_out;
// - grad_x: four partial sums a_q over the channels c = q (mod 4), each from
//   0 over c ascending by fmaf, then (a_0 + a_1) + (a_2 + a_3).
// (The tiled body of other nets keeps the forward's, backward's and
// gradient's orders; its net's sum is its own.) Both bodies share the GELU
// and update code, every rounding written out.
//
// Two bodies, chosen by shape or on request:
//
// - rollout_potential_reg_kernel<D>, the register path, for C = 64,
//   H = 2: with D = 1..16 the fast body, with D = 0 (d at run time) the
//   generic body's path for this net (mw_50d: d = 50). A block of 8 rows
//   (the generic body's plan: at most 8) stages the weights, and each of
//   its warps then owns RT = 2 rows alone: a lane owns channels c and c + 32
//   of them. Channel c's hidden columns stay in registers for the whole
//   launch (as rollout.cuh's fast body keeps them), c + 32's are read as
//   float4s of W_l^T's row (staged once more for the channels 32..63), and
//   each activation float4, a warp-uniform broadcast, serves both: 16 fmas
//   for 3 16-byte shared loads in the forward (4 in a block whose thread
//   owns one channel of 4 rows), 4 in the backward, where a lane reads W_l's
//   rows c and c + 32. The lane keeps the GELU derivatives of its channels
//   and rows (12 floats) from the forward to the backward and sums the
//   net's halves by shuffles, so no data crosses warps in a step: its six
//   phases are separated by __syncwarp, with no block barrier, and the
//   SM's 8 warps run apart. In the fast body a lane owns one float of its
//   warp's tile (2 d <= 32): its state's copies, its noise's cp.async and
//   the gradient's (row, coordinate) pair, four 16-long chains, whose
//   update it writes; the generic body's pairs go 2 x 2 to a lane. The input
//   layer reads W_in^T's rows as float4s where they fit (d <= 280), else
//   W_in's columns. The time embedding and the step's scalars are read a
//   step ahead from device memory and step k+1's noise arrives by cp.async
//   while step k computes, so no step waits on device memory and the shared
//   memory does not grow with T. Where d is wide (d = 530: W_in alone is
//   141 KB) the plan takes fewer rows a block.
// - rollout_potential_tiled_kernel, the generic body for any other net:
//   256 threads over 2 x 2 register tiles of every product (rollout.cuh's
//   tile_fma forward, tile_fma_nt backward, grad_tile gradient), the GELU
//   derivatives of every layer in shared memory, at most 16 rows a block.
#include "rollout.cuh"

namespace sde_rollout {

// The exact GELU of z and its derivative, from one erff. Here and in the
// update every rounding is written out (__fmul_rn, __fadd_rn, fmaf), so that
// nvcc contracts none differently in the two bodies' surroundings.
__device__ __forceinline__ void gelu_and_grad(float z, float& g, float& gp) {
  const float e = erff(__fmul_rn(z, 0.70710678118654752440f));
  const float h = __fadd_rn(1.0f, e);
  g = __fmul_rn(__fmul_rn(0.5f, z), h);
  gp = fmaf(__fmul_rn(z, 0.39894228040143267794f), expf(__fmul_rn(__fmul_rn(-0.5f, z), z)),
            __fmul_rn(0.5f, h));
}

// One coordinate's EM update from its masked potential gradient:
// x + (drift x + diff u) dt + diff db with u = diff grad.
__device__ __forceinline__ float potential_update(float x, float grad, float drift, float diff,
                                                  float dt, float db) {
  const float u = __fmul_rn(diff, grad);
  const float f = fmaf(diff, u, __fmul_rn(drift, x));
  return fmaf(diff, db, fmaf(f, dt, x));
}

// ---------------------------------------------------------------- products

// acc[rr][cc] += sum_k b[cc][k] a[rr][k] for k = 0..K-1 in order (fmaf): TM
// rows of `a` (row stride lda) against TN rows of `b` (row stride ldb), both
// read as float4s along k (strides multiples of 4, rows 16-byte aligned).
// The backward's W_l^T delta, with `b` the rows of W_l in its (in, out)
// layout. KC > 0: K is KC, known at compile time.
template <int TM, int TN, int KC = 0>
__device__ __forceinline__ void tile_fma_nt(float (&acc)[TM][TN], const float* a, int lda,
                                            const float* b, int ldb, int K) {
  if constexpr (KC > 0) K = KC;
  const int K4 = K & ~3;
#pragma unroll(KC > 0 ? KC / 4 : 4)
  for (int k = 0; k < K4; k += 4) {
    float4 av[TM], bv[TN];
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) av[rr] = ld4(a + rr * lda + k);
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) bv[cc] = ld4(b + cc * ldb + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
        for (int cc = 0; cc < TN; ++cc)
          acc[rr][cc] = fmaf((&bv[cc].x)[kk], (&av[rr].x)[kk], acc[rr][cc]);
      }
    }
  }
  for (int k = K4; k < K; ++k) {
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) acc[rr][cc] = fmaf(b[cc * ldb + k], a[rr * lda + k], acc[rr][cc]);
    }
  }
}

// g[rr][cc] = sum_k b[cc][k] a[rr][k] in the gradient's order: four partial
// sums over k = q (mod 4), each from 0 over k ascending (fmaf), then
// (a_0 + a_1) + (a_2 + a_3); operands as for tile_fma_nt. Four independent
// chains of K / 4 a sum. KC > 0: K is KC, known at compile time.
template <int TM, int TN, int KC = 0>
__device__ __forceinline__ void grad_tile(float (&g)[TM][TN], const float* a, int lda,
                                          const float* b, int ldb, int K) {
  if constexpr (KC > 0) K = KC;
  float p[TM][TN][4];
#pragma unroll
  for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) {
#pragma unroll
      for (int q = 0; q < 4; ++q) p[rr][cc][q] = 0.0f;
    }
  }
  const int K4 = K & ~3;
#pragma unroll(KC > 0 ? KC / 4 : 4)
  for (int k = 0; k < K4; k += 4) {
    float4 av[TM], bv[TN];
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) av[rr] = ld4(a + rr * lda + k);
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) bv[cc] = ld4(b + cc * ldb + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
        for (int cc = 0; cc < TN; ++cc)
          p[rr][cc][q] = fmaf((&bv[cc].x)[q], (&av[rr].x)[q], p[rr][cc][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (K4 + q >= K) break;
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
      for (int cc = 0; cc < TN; ++cc)
        p[rr][cc][q] = fmaf(b[cc * ldb + K4 + q], a[rr * lda + K4 + q], p[rr][cc][q]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
    for (int cc = 0; cc < TN; ++cc)
      g[rr][cc] = __fadd_rn(__fadd_rn(p[rr][cc][0], p[rr][cc][1]),
                            __fadd_rn(p[rr][cc][2], p[rr][cc][3]));
  }
}

// ---------------------------------------------------------------- layouts

// Float offsets of the tiled body's shared memory at d = D and R rows a
// block, each array at a multiple of 4 floats; rows of weights,
// activations, deltas and GELU derivatives padded to pad4(C) + 4 floats:
// the weights, biases and out_layer, two activation buffers, the GELU
// derivatives of every layer, the net of each row, the state tile (row
// stride pad4(D), read as float4s by the input layer) and the noise of two
// steps. `total` is the size in floats, -1 for shapes past any block.
struct PotentialLayout {
  int win, whid, bhid, wout, a, b, gp, net, x, db, db_floats;
  long long total;
};

__host__ __device__ inline PotentialLayout potential_layout(int D, int C, int H, int R) {
  PotentialLayout l{};
  if (D < 1 || C < 1 || (long long)D * C > (1 << 24) || (long long)H * C * C > (1 << 24)) {
    l.total = -1;
    return l;
  }
  const int RP = pad4(R), CP = pad4(C), WS = CP + 4, DP = pad4(D);
  long long o = 0;
  l.win = (int)o, o += (long long)D * WS;
  l.whid = (int)o, o += (long long)H * C * WS;
  l.bhid = (int)o, o += H * CP;
  l.wout = (int)o, o += CP;
  l.a = (int)o, o += RP * WS;
  l.b = (int)o, o += RP * WS;
  l.gp = (int)o, o += (H + 1) * RP * WS;
  l.net = (int)o, o += pad4(RP);
  l.x = (int)o, o += (long long)RP * DP;
  l.db_floats = pad4(R * D);
  l.db = (int)o, o += 2LL * l.db_floats;
  l.total = o;
  return l;
}

// The register path's rows a warp (2 rows a warp keep two warps a
// scheduler busy: 4 ran 1.4x slower, PERF.md §6), and warps a block of
// kRegRows rows at most.
constexpr int kPotentialRT = 2;
constexpr int kPotentialWarps = kRegRows / kPotentialRT;

// The register path (C = 64, H = 2) at kPotentialRT rows a warp and W warps a block:
// the weights, shared by the block's warps (W_in and every W_l in their
// (in, out) layout, and W_l^T's rows of the out channels 32..63, all rows
// padded to kActStride floats; with `wint`, W_in^T too, its rows padded to
// wint_stride(D) floats), then each warp's own activation buffers (RT,
// kActStride), state tile (RT, pad4(D)) and noise of two steps (RT =
// kPotentialRT).
struct RegLayout {
  int win, whid, wfwd, wint, warps, warp, a, b, x, db, db_floats;
  long long total;
};

// W_in^T's row stride: pad4(D), or 4 floats more, so that its rows' 16-byte
// slots fall on an odd stride (conflict-free float4s across 8 lanes).
__host__ __device__ constexpr int wint_stride(int D) {
  return pad4(D) / 4 % 2 == 1 ? pad4(D) : pad4(D) + 4;
}

__host__ __device__ inline RegLayout reg_layout(int D, int W, bool wint) {
  constexpr int C = kFastC, H = kFastH, AS = kActStride, RT = kPotentialRT;
  RegLayout l{};
  if (D < 1 || D > (1 << 20) || W < 1) {
    l.total = -1;
    return l;
  }
  long long o = 0;
  l.win = (int)o, o += (long long)D * AS;
  l.whid = (int)o, o += H * C * AS;
  l.wfwd = (int)o, o += H * (C / 2) * AS;
  l.wint = (int)o, o += wint ? (long long)C * wint_stride(D) : 0;
  l.warps = (int)o;
  l.db_floats = pad4(RT * D);
  int w = 0;  // one warp's floats, from its start
  l.a = w, w += RT * AS;
  l.b = w, w += RT * AS;
  l.x = w, w += RT * pad4(D);
  l.db = w, w += 2 * l.db_floats;
  l.warp = w;
  l.total = o + (long long)W * w;
  return l;
}

// ---------------------------------------------------------------- register path

// Warp-wide cp.async of n floats into shared memory, by its 32 lanes, in
// the caller's commit group; 16 bytes at a time where both sides allow it.
__device__ __forceinline__ void warp_copy_async(float* dst, const float* src, int n, int lane) {
  const size_t addr = reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst);
  if (n % 4 == 0 && (addr & 15) == 0) {
    for (int i = 4 * lane; i < n; i += 128) cp_async16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
  }
}

// The fast body (kD = 1..16) and the generic body's register path (kD = 0, d
// at run time), for C = 64, H = 2: see the header. Each warp owns RT rows
// of the block's R; a lane owns channels c = lane and c + 32 of its warp's
// rows: channel c's hidden columns in registers, channel c + 32's read from
// W_l^T's rows, whose float4s along j (as the activations', warp-uniform
// broadcasts) serve RT rows. Nothing is shared between warps after the
// weights are staged, so a step has no block barrier: its phases are
// separated by __syncwarp.
template <int kD>
__global__ void __launch_bounds__(32 * kPotentialWarps, 2) rollout_potential_reg_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ xs, float* __restrict__ x_T, int B,
    int d, int T, int R, bool wint, float clip_model) {
  constexpr int C = kFastC, H = kFastH, AS = kActStride, RT = kPotentialRT, HC = C / 2;
  static_assert(AS == pad4(kFastC) + 4, "activation and weight rows share the padded stride");
  static_assert(HC == 32, "a lane owns channels lane and lane + 32");
  static_assert(kD == 0 || RT * kD <= 32, "a lane owns one float of the fast tile");
  const int D = kD > 0 ? kD : d;
  const int DP = pad4(D);
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const RegLayout L = reg_layout(D, blockDim.x >> 5, wint);
  float* s_win = sm + L.win;    // (D, AS) W_in, (in, out)
  float* s_wt = sm + L.whid;    // (H, C, AS) W_l, (in, out): the backward's rows
  float* s_wf = sm + L.wfwd;    // (H, HC, AS) W_l^T's rows of the out channels HC..C-1
  float* s_wint = sm + L.wint;  // (C, DT) W_in^T, with `wint`
  float* s_w = sm + L.warps + warp * L.warp;  // this warp's own
  float* s_a = s_w + L.a;       // (RT, AS) activations, then deltas
  float* s_b = s_w + L.b;       // (RT, AS)
  float* s_x = s_w + L.x;       // (RT, DP) state tile
  float* s_db = s_w + L.db;     // 2 x (RT, D) noise

  // this warp's rows, from row0 of the batch
  const int row0 = blockIdx.x * R + warp * RT;
  const int nrows = min(RT, min(R - warp * RT, B - row0));
  const int nx = nrows * D;  // valid floats of the warp's tile
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;
  const int c = lane, c2 = lane + HC;

  copy_rows_async(s_win, AS, w_in, (size_t)C, D, C);
  copy_rows_async(s_wt, AS, w_hid, (size_t)C, H * C, C);
  for (int i = tid; i < H * HC * C; i += blockDim.x) {  // W_l^T, out channels HC..C-1
    const int l = i / (HC * C), rest = i - l * HC * C, o = rest / C, j = rest - o * C;
    s_wf[(l * HC + o) * AS + j] = w_hid[(l * C + j) * C + HC + o];
  }
  const int DT = wint_stride(D);
  if (wint) {
    for (int i = tid; i < C * D; i += blockDim.x) {  // W_in^T
      const int o = i / D, j = i - o * D;
      s_wint[o * DT + j] = w_in[j * C + o];
    }
  }
  if (nrows > 0) {
    for (int r = 0; r < nrows; ++r) warp_copy_async(s_x + r * DP, x0 + tile_off + r * D, D, lane);
    warp_copy_async(s_db, dbs + tile_off, nx, lane);
  }
  cp_async_commit();
  for (int i = lane; i < RT * DP; i += 32) {  // rows past B and the padding
    const int r = i / DP;
    if (r >= nrows || i - r * DP >= D) s_x[i] = 0.0f;
  }
  // channel c's hidden columns stay in registers for the whole launch
  float whid[H][C], bhid[H][2];
#pragma unroll
  for (int l = 0; l < H; ++l) {
    bhid[l][0] = b_hid[l * C + c];
    bhid[l][1] = b_hid[l * C + c2];
#pragma unroll
    for (int j = 0; j < C; ++j) whid[l][j] = w_hid[(l * C + j) * C + c];
  }
  const float wout[2] = {w_out[c], w_out[c2]};
  const float bias_out = b_out[0];
  float temb_next[2] = {__ldg(temb + c), __ldg(temb + c2)};
  cp_async_wait<0>();
  __syncthreads();
  if (nrows <= 0) return;  // a warp past the batch (no block barrier follows)

  // the fast body's tile has at most 32 floats a warp: a lane owns one, its
  // state's copies, noise and (row, coordinate) pair of the gradient (the
  // generic body's pairs go 2 x 2 to a lane)
  const int e_r = lane / D;
  const int e_s = e_r * DP + lane - e_r * D;  // its offset in the state tile
  const bool e_ok = lane < nx;
  // fn(i, offset in the state tile) for each float i < n of the warp's tile
  // (row stride D) this lane owns: i = lane, lane + 32, ..., without a
  // division a float
  auto for_tile = [&](int n, auto fn) {
    int r = e_r, off = e_s;
    for (int i = lane; i < n; i += 32) {
      fn(i, off);
      off += 32;
      for (int j = off - r * DP; j >= D; j -= D) off += DP - D, ++r;
    }
  };
  constexpr int GM = kD > 0 ? 1 : 2;
  const int nq = (D + GM - 1) / GM;
  const int grad_tiles = (nrows + GM - 1) / GM * nq;

  for (int k = 0; k < T; ++k) {
    float* xs_k = xs + (size_t)k * step_stride + tile_off;
    const float* db_next = dbs + (size_t)(k + 1) * step_stride + tile_off;
    float* s_db_next = s_db + ((k + 1) & 1) * L.db_floats;
    if constexpr (kD > 0) {
      if (e_ok) {
        xs_k[lane] = s_x[e_s];
        if (k + 1 < T) cp_async4(s_db_next + lane, db_next + lane);
      }
    } else {
      for_tile(nx, [&](int i, int off) { xs_k[i] = s_x[off]; });
      if (k + 1 < T) warp_copy_async(s_db_next, db_next, nx, lane);
    }
    cp_async_commit();  // one group per step, empty on the last
    const float temb_c[2] = {temb_next[0], temb_next[1]};
    if (k + 1 < T) {
      temb_next[0] = __ldg(temb + (size_t)(k + 1) * C + c);
      temb_next[1] = __ldg(temb + (size_t)(k + 1) * C + c2);
    }
    const float* st = tab + (size_t)k * kTab;
    const float drift = __ldg(st), diff = __ldg(st + 1), dt = __ldg(st + 2);

    // h_0 = input_embed(x) + timestep_embed(s) (bias folded into temb), both
    // channels from W_in's columns in shared memory
    float acc[RT][2], gp[H + 1][RT][2];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[rr][0] = temb_c[0], acc[rr][1] = temb_c[1];
    // (W_in's columns c and c + 32: float4s of W_in^T's rows where staged)
    const int D4 = D & ~3;
#pragma unroll(kD > 0 ? (kD + 3) / 4 : 4)
    for (int j0 = 0; j0 < D4; j0 += 4) {
      float4 xv[RT];
      float w[4][2];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) xv[rr] = ld4(s_x + rr * DP + j0);
      if (wint) {
        const float4 w0 = ld4(s_wint + c * DT + j0), w1 = ld4(s_wint + c2 * DT + j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) w[jj][0] = (&w0.x)[jj], w[jj][1] = (&w1.x)[jj];
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          w[jj][0] = s_win[(j0 + jj) * AS + c], w[jj][1] = s_win[(j0 + jj) * AS + c2];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          acc[rr][0] = fmaf(w[jj][0], (&xv[rr].x)[jj], acc[rr][0]);
          acc[rr][1] = fmaf(w[jj][1], (&xv[rr].x)[jj], acc[rr][1]);
        }
      }
    }
#pragma unroll
    for (int j = D4; j < (kD > 0 ? kD : D); ++j) {
      const float w0 = s_win[j * AS + c], w1 = s_win[j * AS + c2];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const float xj = s_x[rr * DP + j];
        acc[rr][0] = fmaf(w0, xj, acc[rr][0]);
        acc[rr][1] = fmaf(w1, xj, acc[rr][1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      gelu_and_grad(acc[rr][0], s_a[rr * AS + c], gp[0][rr][0]);
      gelu_and_grad(acc[rr][1], s_a[rr * AS + c2], gp[0][rr][1]);
    }
    __syncwarp();

    // the hidden layers: channel c from registers, c + 32 from W_l^T's row
    float net[RT], lo[RT], hi[RT];
#pragma unroll
    for (int l = 0; l < H; ++l) {
      const float* in = l == 0 ? s_a : s_b;
      const float* wf = s_wf + (l * HC + lane) * AS;
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr][0] = bhid[l][0], acc[rr][1] = bhid[l][1];
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        float4 a[RT];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) a[rr] = ld4(in + rr * AS + j0);
        const float4 w4 = ld4(wf + j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) {
            acc[rr][0] = fmaf(whid[l][j0 + jj], (&a[rr].x)[jj], acc[rr][0]);
            acc[rr][1] = fmaf((&w4.x)[jj], (&a[rr].x)[jj], acc[rr][1]);
          }
        }
      }
      if (l == 0) {
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          gelu_and_grad(acc[rr][0], s_b[rr * AS + c], gp[1][rr][0]);
          gelu_and_grad(acc[rr][1], s_b[rr * AS + c2], gp[1][rr][1]);
        }
        __syncwarp();
        continue;
      }
      // the last: delta_H = w_out * gelu'(h_H) into s_a, and the net's
      // products, rounded on their own
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        float g0, g1;
        gelu_and_grad(acc[rr][0], g0, gp[H][rr][0]);
        gelu_and_grad(acc[rr][1], g1, gp[H][rr][1]);
        s_a[rr * AS + c] = wout[0] * gp[H][rr][0];
        s_a[rr * AS + c2] = wout[1] * gp[H][rr][1];
        lo[rr] = __fmul_rn(wout[0], g0);
        hi[rr] = __fmul_rn(wout[1], g1);
      }
    }
    __syncwarp();
    // the net of each row, beside the backward: each 32 channels' products
    // summed by a xor butterfly (every lane ends with the same bits), then
    // the halves and b_out
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        lo[rr] = __fadd_rn(lo[rr], __shfl_xor_sync(0xffffffffu, lo[rr], m));
        hi[rr] = __fadd_rn(hi[rr], __shfl_xor_sync(0xffffffffu, hi[rr], m));
      }
    }
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) net[rr] = __fadd_rn(__fadd_rn(lo[rr], hi[rr]), bias_out);

    // delta_l = (W_l^T delta_{l+1}) * gelu'(h_l) of channels c and c + 32,
    // down to delta_0: W_l's rows c and c + 32 against the deltas' rows,
    // both along the channels
    float* dn = s_a;
    float* dp = s_b;
#pragma unroll
    for (int l = H - 1; l >= 0; --l) {
      float sums[RT][2] = {};
      tile_fma_nt<RT, 2, C>(sums, dn, AS, s_wt + (l * C + c) * AS, HC * AS, C);
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        dp[rr * AS + c] = sums[rr][0] * gp[l][rr][0];
        dp[rr * AS + c2] = sums[rr][1] * gp[l][rr][1];
      }
      if (l == 0) cp_async_wait<1>();  // this step's noise has landed
      __syncwarp();
      float* tmp = dn;
      dn = dp;
      dp = tmp;
    }

    // grad_x = m W_in^T delta_0 of each (row, coordinate) pair, and its update
    const float* db_k = s_db + (k & 1) * L.db_floats;
    if constexpr (kD > 0) {
      if (e_ok) {
        float g[1][1];
        grad_tile<1, 1, C>(g, dn + e_r * AS, AS, s_win + (lane - e_r * D) * AS, AS, C);
        float m = net[0];
#pragma unroll
        for (int q = 1; q < RT; ++q) m = e_r == q ? net[q] : m;
        s_x[e_s] = potential_update(s_x[e_s], fabsf(m) <= clip_model ? g[0][0] : 0.0f, drift,
                                    diff, dt, db_k[lane]);
      }
      __syncwarp();
      continue;
    }
    for (int t = lane; t < grad_tiles; t += 32) {
      const int rt = t / nq, i0 = GM * (t - rt * nq);
      float g[GM][GM];
      grad_tile<GM, GM, C>(g, dn + GM * rt * AS, AS, s_win + i0 * AS, AS, C);
#pragma unroll
      for (int rr = 0; rr < GM; ++rr) {
        const int r = GM * rt + rr;
        float m = net[0];
#pragma unroll
        for (int q = 1; q < RT; ++q) m = r == q ? net[q] : m;
        const bool on = fabsf(m) <= clip_model;
#pragma unroll
        for (int cc = 0; cc < GM; ++cc) {
          const int i = i0 + cc;
          if (r >= nrows || i >= D) continue;
          float* x = s_x + r * DP + i;
          *x = potential_update(*x, on ? g[rr][cc] : 0.0f, drift, diff, dt, db_k[r * D + i]);
        }
      }
    }
    __syncwarp();
  }

  for_tile(nx, [&](int i, int off) { x_T[tile_off + i] = s_x[off]; });
}

// ---------------------------------------------------------------- tiled body

// The generic body for every other net (C, H): 256 threads over 2 x 2
// register tiles of each product, R rows a block (the plan's, at most
// kMaxRows). Every weight, the state tile and step 0's noise are staged once
// by cp.async; step k+1's noise arrives while step k computes. A step: the
// input layer, the H hidden layers (each keeping its GELU derivatives in
// shared memory), the net of each row (a warp a row) beside delta_H, the H
// transposed products and the gradient with the update: 2 H + 3 barriers.
__global__ void __launch_bounds__(kTileThreads) rollout_potential_tiled_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ xs, float* __restrict__ x_T, int B,
    int D, int C, int H, int T, int R, float clip_model) {
  constexpr int TM = kLayerRows, TN = kLayerCols, NT = kTileThreads;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const PotentialLayout L = potential_layout(D, C, H, R);
  const int RP = pad4(R), CP = pad4(C), AS = CP + 4, DP = pad4(D);
  float* s_win = sm + L.win;    // (D, AS) W_in, (in, out)
  float* s_whid = sm + L.whid;  // (H, C, AS) W_l, (in, out)
  float* s_bhid = sm + L.bhid;  // (H, CP)
  float* s_wout = sm + L.wout;  // (CP)
  float* s_a = sm + L.a;        // (RP, AS) activations and deltas, ping
  float* s_b = sm + L.b;        // (RP, AS) pong
  float* s_gp = sm + L.gp;      // (H + 1, RP, AS) gelu'(h_l)
  float* s_net = sm + L.net;    // (RP) the net of each row
  float* s_x = sm + L.x;        // (RP, DP) state tile
  float* s_db = sm + L.db;      // 2 x (R, D) noise

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int nx = nrows * D;
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;
  const float bias_out = b_out[0];

  copy_rows_async(s_win, AS, w_in, (size_t)C, D, C);
  copy_rows_async(s_whid, AS, w_hid, (size_t)C, H * C, C);
  copy_rows_async(s_bhid, CP, b_hid, (size_t)C, H, C);
  copy_async(s_wout, w_out, C);
  copy_rows_async(s_x, DP, x0 + tile_off, (size_t)D, nrows, D);
  copy_async(s_db, dbs + tile_off, nx);
  cp_async_commit();
  for (int i = tid; i < RP * DP; i += NT) {  // rows past B and the padding
    const int r = i / DP;
    if (r >= nrows || i - r * DP >= D) s_x[i] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int nqc = (C + TN - 1) / TN;  // the C-wide products' column groups
  const int c_tiles = RP / TM * nqc;
  const int nqd = (D + TN - 1) / TN;  // the gradient's
  const int d_tiles = (nrows + TM - 1) / TM * nqd;

  // out = gelu(h), gp = gelu'(h) of h = bias + in . w over K inputs
  auto forward = [&](float* out, float* gp, const float* in, int ldi, const float* w,
                     const float* bias, int K) {
    for (int t = tid; t < c_tiles; t += NT) {
      const int rt = t / nqc, c0 = TN * (t - rt * nqc);
      float acc[TM][TN];
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) {
        const float b = bias[min(c0 + cc, C - 1)];
#pragma unroll
        for (int rr = 0; rr < TM; ++rr) acc[rr][cc] = b;
      }
      tile_fma<TM, TN>(acc, in + rt * TM * ldi, ldi, w + c0, AS, K);
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
        for (int cc = 0; cc < TN; ++cc) {
          if (c0 + cc >= C) continue;
          const int o = (rt * TM + rr) * AS + c0 + cc;
          gelu_and_grad(acc[rr][cc], out[o], gp[o]);
        }
      }
    }
  };

  for (int k = 0; k < T; ++k) {
    float* xs_k = xs + (size_t)k * step_stride + tile_off;
    for (int i = tid; i < nx; i += NT) {
      const int r = i / D;
      xs_k[i] = s_x[r * DP + i - r * D];
    }
    if (k + 1 < T)
      copy_async(s_db + ((k + 1) & 1) * L.db_floats, dbs + (size_t)(k + 1) * step_stride + tile_off,
                 nx);
    cp_async_commit();  // one group per step, empty on the last
    const float* st = tab + (size_t)k * kTab;
    const float drift = __ldg(st), diff = __ldg(st + 1), dt = __ldg(st + 2);

    // the forward, keeping every layer's GELU derivatives
    forward(s_a, s_gp, s_x, DP, s_win, temb + (size_t)k * C, D);
    __syncthreads();
    float* in = s_a;
    float* out = s_b;
    for (int l = 0; l < H; ++l) {
      forward(out, s_gp + (l + 1) * RP * AS, in, AS, s_whid + (size_t)l * C * AS, s_bhid + l * CP,
              C);
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }

    // the net of each row (a warp a row), and delta_H = w_out * gelu'(h_H)
    for (int r = warp; r < RP; r += NT / 32) {
      float p = 0.0f;
      for (int j = lane; j < C; j += 32) p = fmaf(s_wout[j], in[r * AS + j], p);
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
      if (lane == 0) s_net[r] = p + bias_out;
    }
    if (H == 0) cp_async_wait<1>();  // this step's noise has landed
    const float* gp_h = s_gp + H * RP * AS;
    for (int i = tid; i < RP * C; i += NT) {
      const int r = i / C, j = i - r * C;
      out[r * AS + j] = s_wout[j] * gp_h[r * AS + j];
    }
    __syncthreads();

    // delta_l = (W_l^T delta_{l+1}) * gelu'(h_l), down to delta_0
    float* dn = out;
    float* dp = in;
    for (int l = H - 1; l >= 0; --l) {
      const float* W = s_whid + (size_t)l * C * AS;
      const float* gp = s_gp + l * RP * AS;
      for (int t = tid; t < c_tiles; t += NT) {
        const int rt = t / nqc, j0 = TN * (t - rt * nqc);
        float acc[TM][TN] = {};
        tile_fma_nt<TM, TN>(acc, dn + rt * TM * AS, AS, W + j0 * AS, AS, C);
#pragma unroll
        for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
          for (int cc = 0; cc < TN; ++cc) {
            if (j0 + cc >= C) continue;
            const int o = (rt * TM + rr) * AS + j0 + cc;
            dp[o] = acc[rr][cc] * gp[o];
          }
        }
      }
      if (l == 0) cp_async_wait<1>();  // this step's noise has landed
      __syncthreads();
      float* tmp = dn;
      dn = dp;
      dp = tmp;
    }

    // grad_x = m W_in^T delta_0, and the update of the coordinates each tile outputs
    const float* db_k = s_db + (k & 1) * L.db_floats;
    for (int t = tid; t < d_tiles; t += NT) {
      const int rt = t / nqd, i0 = TN * (t - rt * nqd);
      float g[TM][TN];
      grad_tile<TM, TN>(g, dn + rt * TM * AS, AS, s_win + i0 * AS, AS, C);
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) {
        const int r = rt * TM + rr;
        const bool on = fabsf(s_net[r]) <= clip_model;
#pragma unroll
        for (int cc = 0; cc < TN; ++cc) {
          const int i = i0 + cc;
          if (r >= nrows || i >= D) continue;
          float* x = s_x + r * DP + i;
          *x = potential_update(*x, on ? g[rr][cc] : 0.0f, drift, diff, dt, db_k[r * D + i]);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nx; i += NT) {
    const int r = i / D;
    x_T[tile_off + i] = s_x[r * DP + i - r * D];
  }
}

// ---------------------------------------------------------------- launch

// Shared memory (bytes) of the register path and the tiled body at R rows
// a block (-1 past any block). The register path stages W_in^T where it
// fits beside the rest at kRegRows rows (up to d = 280).
inline long long reg_smem(const Args& a, int R, bool wint) {
  const RegLayout l = reg_layout(a.D, (R + kPotentialRT - 1) / kPotentialRT, wint);
  return l.total < 0 ? -1 : (long long)sizeof(float) * l.total;
}

inline bool reg_wint(const Args& a) { return smem_fits(reg_smem(a, kRegRows, true)); }

inline long long potential_reg_smem(const Args& a, int R) { return reg_smem(a, R, reg_wint(a)); }

inline long long potential_tiled_smem(const Args& a, int R) {
  const PotentialLayout l = potential_layout(a.D, a.C, a.H, R);
  return l.total < 0 ? -1 : (long long)sizeof(float) * l.total;
}

// A launch of the register path at `rows` rows a block: a warp per
// kPotentialRT of them.
template <int D>
void launch_reg_kernel(const Args& a, int blocks, int rows, size_t smem) {
  const int threads = 32 * ((rows + kPotentialRT - 1) / kPotentialRT);
  rollout_potential_reg_kernel<D><<<blocks, threads, smem, a.stream>>>(
      a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out, a.b_out, a.xs, a.x_T, a.B,
      D > 0 ? D : a.D, a.T, rows, reg_wint(a), a.cs.clip_model);
}

template <int D>
cudaError_t launch_potential_fast(const Args& a) {
  const long long smem = potential_reg_smem(a, kRegRows);
  const int blocks = (a.B + kRegRows - 1) / kRegRows;
  if (a.plan != nullptr) *a.plan = Plan{kRegRows, blocks, (int)smem, 0};
  if (a.dry) return cudaSuccess;
  static TileCache cache = tile_cache(rollout_potential_reg_kernel<D>);
  if (cache.attr != cudaSuccess) return cache.attr;
  launch_reg_kernel<D>(a, blocks, kRegRows, (size_t)smem);
  return cudaGetLastError();
}

cudaError_t launch_potential_reg(const Args& a) {
  auto kernel = rollout_potential_reg_kernel<0>;
  static TileCache cache = tile_cache(kernel);
  return launch_tiled(a, kernel, cache, potential_reg_smem, 0, 32 * kPotentialWarps, kRegRows,
                      [&](int blocks, int rows, size_t smem) {
                        launch_reg_kernel<0>(a, blocks, rows, smem);
                      },
                      kPotentialRT);
}

cudaError_t launch_potential_tiled(const Args& a) {
  auto kernel = rollout_potential_tiled_kernel;
  static TileCache cache = tile_cache(kernel);
  return launch_tiled(a, kernel, cache, potential_tiled_smem, 0, kTileThreads, kMaxRows,
                      [&](int blocks, int rows, size_t smem) {
                        kernel<<<blocks, kTileThreads, smem, a.stream>>>(
                            a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out,
                            a.b_out, a.xs, a.x_T, a.B, a.D, a.C, a.H, a.T, rows,
                            a.cs.clip_model);
                      });
}

// The body choice of `launch` (rollout.cuh) for this form's own kernels: by
// shape the fast body for C = 64, H = 2, d <= 16; else the generic body, its
// register path for C = 64, H = 2 where it fits, else the tiled one. A body
// asked for that does not take the shape fails; so does a shape no body
// takes. `a.dry` plans without launching.
int launch_potential(const Args& a, int body, int* used) {
  if (a.B <= 0 || a.T <= 0 || used == nullptr) return (int)cudaErrorInvalidValue;
  if (body != kByShape && body != kFastBody && body != kGenericBody)
    return (int)cudaErrorInvalidValue;
  const bool fits = reg_path(a) && a.D >= 1 && a.D <= 16 &&
                    smem_fits(potential_reg_smem(a, kRegRows));
  const bool reg_ok = reg_path(a) && max_rows(a, potential_reg_smem, kRegRows) > 0;
  const bool generic_ok = reg_ok || max_rows(a, potential_tiled_smem) > 0;
  const bool fast = body == kFastBody || (body == kByShape && fits);
  if ((fast && !fits) || (!fast && !generic_ok)) return (int)cudaErrorInvalidValue;
  *used = fast ? kFastBody : kGenericBody;
  if (!fast) return (int)(reg_ok ? launch_potential_reg(a) : launch_potential_tiled(a));
  switch (a.D) {
#define SDE_CASE(DD) \
  case DD:           \
    return (int)launch_potential_fast<DD>(a);
    SDE_CASE(1) SDE_CASE(2) SDE_CASE(3) SDE_CASE(4) SDE_CASE(5) SDE_CASE(6)
    SDE_CASE(7) SDE_CASE(8) SDE_CASE(9) SDE_CASE(10) SDE_CASE(11)
    SDE_CASE(12) SDE_CASE(13) SDE_CASE(14) SDE_CASE(15) SDE_CASE(16)
#undef SDE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sde_rollout
