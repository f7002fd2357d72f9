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
// per-step tables are those of the other forms (rollout.cuh); the score
// columns are unused.
//
// Bound on an H100: operations. The backward repeats the forward's
// multiply-adds (C d + H C^2 + C per row and step) and adds a GELU
// derivative per activation, about twice the arithmetic of the ClippedCtrl
// form; the bytes moved are the same (noise in, states out).
//
// The hard part is the backward's sums over channels: the forward gives each
// thread one output channel with that channel's weights in registers, while
// W^T delta sums over the channels the thread does not own. Here the
// transposed products read the weights from shared memory instead, in the
// layout that makes them conflict-free, and each thread keeps the GELU
// derivatives of its own channel and rows in registers between the forward
// and the backward.
//
// Two bodies, as for the other forms, chosen by shape or on request:
//
// - rollout_potential_fast_kernel<D>: C = 64, H = 2, D = 1..16; one block of
//   128 threads per 8 rows, two blocks per SM. In the forward a thread owns
//   one channel of 4 rows, its weights in registers (as rollout.cuh's fast
//   body), and keeps gelu'(h_l) of its channel and rows (12 floats). In the
//   backward the same thread computes delta_l of that channel and those rows,
//   reading W_l[c][j] over c from shared memory (W_l in its (out, in) layout,
//   so a warp's 32 channels j read 32 neighbouring words) and delta_{l+1} as
//   warp-uniform float4 broadcasts. The net of a row and the update of each of
//   its coordinates run in one thread per (row, coordinate), with W_in^T in
//   shared memory as (C, D). A step is six phases between barriers; the
//   tables, the transposed weights and step k+1's noise (cp.async) sit in
//   shared memory as in rollout.cuh.
// - rollout_potential_generic_kernel: any (C, H, D); one block per 16 rows,
//   threads over (row, channel) pairs in the forward and over (channel, row)
//   pairs in the backward (delta rows padded to C + 1 floats, so that the 16
//   rows of a warp fall in 16 banks), the GELU derivatives of every layer in
//   shared memory.
//
// Every sum runs in the same order in both bodies (the forward's from its
// bias, the net's from b_out, the backward's and the gradient's from 0, each
// over its index ascending, by fmaf), and both share the GELU and update
// code, so the two bodies give the same bits.
#include "rollout.cuh"

namespace sde_rollout {

// The exact GELU of z and its derivative, from one erff.
__device__ __forceinline__ void gelu_and_grad(float z, float& g, float& gp) {
  const float e = erff(z * 0.70710678118654752440f);
  g = 0.5f * z * (1.0f + e);
  gp = fmaf(z * 0.39894228040143267794f, expf(-0.5f * z * z), 0.5f * (1.0f + e));
}

// One coordinate's EM update from its masked potential gradient.
__device__ __forceinline__ float potential_update(float x, float grad, const float* st,
                                                  float db) {
  const float drift = st[0], diff = st[1], dt = st[2];
  const float u = diff * grad;
  return x + (drift * x + diff * u) * dt + diff * db;
}

// ---------------------------------------------------------------- generic

__global__ void __launch_bounds__(kGenericThreads) rollout_potential_generic_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ xs, float* __restrict__ x_T,
    int B, int D, int C, int H, int T, float clip_model) {
  extern __shared__ float sm[];
  const int CP = C + 1;                     // padded delta and derivative rows
  const int L = kRows * CP;                 // floats of one (kRows, CP) buffer
  float* s_win = sm;                        // (D, C) input_embed weight, (in, out)
  float* s_whid = s_win + D * C;            // (H, C, C), (in, out)
  float* s_bhid = s_whid + H * C * C;       // (H, C)
  float* s_wout = s_bhid + H * C;           // (C) out_layer weight
  float* s_x = s_wout + C;                  // (kRows, D) state tile
  float* s_a = s_x + kRows * D;             // (kRows, C) activations, ping
  float* s_b = s_a + kRows * C;             // (kRows, C) activations, pong
  float* s_gp = s_b + kRows * C;            // (H + 1, kRows, CP) gelu'(h_l)
  float* s_d = s_gp + (H + 1) * L;          // (kRows, CP) deltas, ping
  float* s_e = s_d + L;                     // (kRows, CP) deltas, pong
  float* s_net = s_e + L;                   // (kRows) the net of each row

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;
  const float bias_out = b_out[0];

  for (int i = tid; i < D * C; i += kGenericThreads) s_win[i] = w_in[i];
  for (int i = tid; i < H * C * C; i += kGenericThreads) s_whid[i] = w_hid[i];
  for (int i = tid; i < H * C; i += kGenericThreads) s_bhid[i] = b_hid[i];
  for (int i = tid; i < C; i += kGenericThreads) s_wout[i] = w_out[i];
  for (int i = tid; i < kRows * D; i += kGenericThreads)
    s_x[i] = i < nrows * D ? x0[tile_off + i] : 0.0f;
  __syncthreads();

  for (int k = 0; k < T; ++k) {
    float* xs_k = xs + (size_t)k * step_stride + tile_off;
    for (int i = tid; i < nrows * D; i += kGenericThreads) xs_k[i] = s_x[i];

    // h_0 = input_embed(x) + timestep_embed(s) (bias folded into temb)
    const float* temb_k = temb + (size_t)k * C;
    for (int i = tid; i < kRows * C; i += kGenericThreads) {
      const int r = i / C, c = i - r * C;
      float acc = temb_k[c];
      for (int j = 0; j < D; ++j) acc = fmaf(s_win[j * C + c], s_x[r * D + j], acc);
      gelu_and_grad(acc, s_a[i], s_gp[r * CP + c]);
    }
    __syncthreads();

    float* in = s_a;
    float* out = s_b;
    for (int l = 0; l < H; ++l) {
      const float* W = s_whid + (size_t)l * C * C;
      const float* bias = s_bhid + l * C;
      float* gp = s_gp + (l + 1) * L;
      for (int i = tid; i < kRows * C; i += kGenericThreads) {
        const int r = i / C, c = i - r * C;
        const float* a = in + r * C;
        float acc = bias[c];
        for (int j = 0; j < C; ++j) acc = fmaf(W[j * C + c], a[j], acc);
        gelu_and_grad(acc, out[i], gp[r * CP + c]);
      }
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }

    // the net of each row, and delta_H = w_out * gelu'(h_H)
    for (int r = tid; r < kRows; r += kGenericThreads) {
      const float* a = in + r * C;
      float acc = bias_out;
      for (int j = 0; j < C; ++j) acc = fmaf(s_wout[j], a[j], acc);
      s_net[r] = acc;
    }
    for (int i = tid; i < kRows * C; i += kGenericThreads) {
      const int r = i / C, c = i - r * C;
      s_d[r * CP + c] = s_wout[c] * s_gp[H * L + r * CP + c];
    }
    __syncthreads();

    // delta_l = (W_l^T delta_{l+1}) * gelu'(h_l), down to delta_0
    float* dn = s_d;
    float* dp = s_e;
    for (int l = H - 1; l >= 0; --l) {
      const float* W = s_whid + (size_t)l * C * C;
      const float* gp = s_gp + l * L;
      for (int i = tid; i < kRows * C; i += kGenericThreads) {
        const int j = i / kRows, r = i - j * kRows;
        const float* dr = dn + r * CP;
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc = fmaf(W[j * C + c], dr[c], acc);
        dp[r * CP + j] = acc * gp[r * CP + j];
      }
      __syncthreads();
      float* tmp = dn;
      dn = dp;
      dp = tmp;
    }

    // grad_x = m W_in^T delta_0, and the update
    const float* db_k = dbs + (size_t)k * step_stride + tile_off;
    const float* st = tab + k * kTab;
    for (int i = tid; i < kRows * D; i += kGenericThreads) {
      const int j = i / kRows, r = i - j * kRows;
      if (r >= nrows) continue;
      const float* dr = dn + r * CP;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc = fmaf(s_win[j * C + c], dr[c], acc);
      const float grad = fabsf(s_net[r]) <= clip_model ? acc : 0.0f;
      s_x[r * D + j] = potential_update(s_x[r * D + j], grad, st, db_k[r * D + j]);
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * D; i += kGenericThreads) x_T[tile_off + i] = s_x[i];
}

// ---------------------------------------------------------------- fast

// Floats of shared memory the fast body needs at a given D and T.
__host__ __device__ constexpr size_t potential_fast_smem_floats(int D, int T) {
  return (size_t)T * (kFastC + kTab) + 3 * kFastRows * kActStride +
         (size_t)kFastH * kFastC * kFastC + (size_t)kFastC * D + kFastC +
         3 * (size_t)kFastRows * D;
}

template <int D>
__global__ void __launch_bounds__(kFastThreads, 2) rollout_potential_fast_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ xs, float* __restrict__ x_T,
    int B, int T, float clip_model) {
  constexpr int C = kFastC, H = kFastH, AS = kActStride, NT = kFastThreads;
  constexpr int RT = kFastRowsPerThread;
  constexpr int R = kFastRows;
  extern __shared__ float4 sm4[];
  // float4-read arrays first, each at a multiple of 4 floats
  float* s_temb = reinterpret_cast<float*>(sm4);  // (T, C)
  float* s_a = s_temb + (size_t)T * C;            // (R, AS) activations, ping
  float* s_b = s_a + R * AS;                      // (R, AS) pong; backward too
  float* s_c = s_b + R * AS;                      // (R, AS) backward
  float* s_wt = s_c + R * AS;                     // (H, C, C): W_l (out, in)
  float* s_wint = s_wt + H * C * C;               // (C, D): W_in (out, in)
  float* s_wout = s_wint + C * D;                 // (C)
  float* s_tab = s_wout + C;                      // (T, kTab)
  float* s_x = s_tab + (size_t)T * kTab;          // (R, D) state tile
  float* s_db = s_x + R * D;                      // 2 x (R, D) noise

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nx = min(R, B - row0) * D;  // valid floats of the tile
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;

  // this thread's channel c of the C-wide layers and its RT rows from r0
  const int warp = tid >> 5, lane = tid & 31;
  const int c = 32 * (warp & 1) + lane;
  const int r0 = RT * (warp >> 1);

  // the forward weights of channel c stay in registers for the whole launch
  float win[D], whid[H][C], bhid[H];
#pragma unroll
  for (int j = 0; j < D; ++j) win[j] = w_in[j * C + c];
#pragma unroll
  for (int l = 0; l < H; ++l) {
    bhid[l] = b_hid[l * C + c];
#pragma unroll
    for (int j = 0; j < C; ++j) whid[l][j] = w_hid[(l * C + j) * C + c];
  }
  const float wout_c = w_out[c];
  const float bias_out = b_out[0];

  copy_in(s_temb, temb, T * C);
  copy_in(s_tab, tab, T * kTab);
  copy_in(s_wout, w_out, C);
  // the backward's weights, transposed: s_wt[l][c][j] = w_hid[l][j][c] and
  // s_wint[c][j] = w_in[j][c]
  for (int i = tid; i < H * C * C; i += NT) {
    const int l = i / (C * C), rest = i - l * C * C, cc = rest / C, j = rest - cc * C;
    s_wt[i] = w_hid[(l * C + j) * C + cc];
  }
  for (int i = tid; i < C * D; i += NT) {
    const int cc = i / D, j = i - cc * D;
    s_wint[i] = w_in[j * C + cc];
  }
  for (int i = tid; i < R * D; i += NT) {
    s_x[i] = i < nx ? x0[tile_off + i] : 0.0f;
    if (i >= nx) s_db[i] = s_db[R * D + i] = 0.0f;  // rows past B
  }
  // step k's noise goes to buffer k & 1 (4-byte copies: a ragged B leaves
  // the tile unaligned)
  auto prefetch = [&](int k) {
    const float* src = dbs + (size_t)k * step_stride + tile_off;
    float* dst = s_db + (k & 1) * R * D;
    for (int i = tid; i < nx; i += NT) cp_async4(dst + i, src + i);
  };
  prefetch(0);
  cp_async_commit();
  __syncthreads();

  // this thread's coordinate of the gradient and the update
  const int o_row = tid >> 4, o_col = tid & 15;
  const bool o_valid = o_col < D;

  for (int k = 0; k < T; ++k) {
    float* xs_k = xs + (size_t)k * step_stride + tile_off;
    for (int i = tid; i < nx; i += NT) xs_k[i] = s_x[i];
    if (k + 1 < T) prefetch(k + 1);
    cp_async_commit();  // one group per step, empty on the last

    // h_0 = input_embed(x) + timestep_embed(s) (bias folded into temb)
    float acc[RT], gp[H + 1][RT];
    {
      const float t = s_temb[(size_t)k * C + c];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = t;
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
          acc[rr] = fmaf(win[j], s_x[(r0 + rr) * D + j], acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
        gelu_and_grad(acc[rr], s_a[(r0 + rr) * AS + c], gp[0][rr]);
    }
    __syncthreads();

    float* in = s_a;
    float* out = s_b;
#pragma unroll
    for (int l = 0; l < H; ++l) {
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = bhid[l];
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        float4 a[RT];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) a[rr] = ld4(in + (r0 + rr) * AS + j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int rr = 0; rr < RT; ++rr)
            acc[rr] = fmaf(whid[l][j0 + jj], (&a[rr].x)[jj], acc[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
        gelu_and_grad(acc[rr], out[(r0 + rr) * AS + c], gp[l + 1][rr]);
      if (l == H - 1) {  // delta_H = w_out * gelu'(h_H)
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) s_c[(r0 + rr) * AS + c] = wout_c * gp[H][rr];
      }
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }

    // the net of row o_row (read after the backward), from gelu(h_H) in `in`
    float net = bias_out;
    if (o_valid) {
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        const float4 a = ld4(in + o_row * AS + j0);
        net = fmaf(s_wout[j0], a.x, net);
        net = fmaf(s_wout[j0 + 1], a.y, net);
        net = fmaf(s_wout[j0 + 2], a.z, net);
        net = fmaf(s_wout[j0 + 3], a.w, net);
      }
    }

    // delta_l = (W_l^T delta_{l+1}) * gelu'(h_l) of channel c, down to delta_0
    float* dn = s_c;
    float* dp = out;  // the activations the last hidden layer read
#pragma unroll
    for (int l = H - 1; l >= 0; --l) {
      const float* W = s_wt + l * C * C;
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = 0.0f;
#pragma unroll 4
      for (int c0 = 0; c0 < C; c0 += 4) {
        float4 dl[RT];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) dl[rr] = ld4(dn + (r0 + rr) * AS + c0);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float w = W[(c0 + cc) * C + c];
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) acc[rr] = fmaf(w, (&dl[rr].x)[cc], acc[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) dp[(r0 + rr) * AS + c] = acc[rr] * gp[l][rr];
      if (l == 0) cp_async_wait<1>();  // this step's noise has landed
      __syncthreads();
      float* tmp = dn;
      dn = dp;
      dp = tmp;
    }

    // grad_x = m W_in^T delta_0 for coordinate o_col of row o_row, and its update
    {
      const int i = o_row * D + o_col;
      if (o_valid && i < nx) {
        const float* dr = dn + o_row * AS;
        float g = 0.0f;
#pragma unroll 8
        for (int cc = 0; cc < C; ++cc) g = fmaf(s_wint[cc * D + o_col], dr[cc], g);
        const float grad = fabsf(net) <= clip_model ? g : 0.0f;
        s_x[i] = potential_update(s_x[i], grad, s_tab + k * kTab, s_db[(k & 1) * R * D + i]);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nx; i += NT) x_T[tile_off + i] = s_x[i];
}

template <int D>
cudaError_t launch_potential_fast(const Args& a) {
  const size_t smem = sizeof(float) * potential_fast_smem_floats(D, a.T);
  auto kernel = rollout_potential_fast_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + kFastRows - 1) / kFastRows;
  kernel<<<blocks, kFastThreads, smem, a.stream>>>(
      a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out, a.b_out, a.xs, a.x_T,
      a.B, a.T, a.cs.clip_model);
  return cudaGetLastError();
}

cudaError_t launch_potential_generic(const Args& a) {
  const size_t smem =
      sizeof(float) * ((size_t)a.D * a.C + (size_t)a.H * a.C * a.C + (size_t)a.H * a.C + a.C +
                       kRows * ((size_t)a.D + 2 * a.C) +
                       (size_t)(a.H + 3) * kRows * (a.C + 1) + kRows);
  cudaError_t err = cudaFuncSetAttribute(
      rollout_potential_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + kRows - 1) / kRows;
  rollout_potential_generic_kernel<<<blocks, kGenericThreads, smem, a.stream>>>(
      a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out, a.b_out, a.xs, a.x_T,
      a.B, a.D, a.C, a.H, a.T, a.cs.clip_model);
  return cudaGetLastError();
}

// The body choice of `launch` (rollout.cuh) for this form's own kernels.
int launch_potential(const Args& a, int body, int* used) {
  if (a.B <= 0 || a.T <= 0 || used == nullptr) return (int)cudaErrorInvalidValue;
  if (body != kByShape && body != kFastBody && body != kGenericBody)
    return (int)cudaErrorInvalidValue;
  const bool fits = a.C == kFastC && a.H == kFastH && a.D >= 1 && a.D <= 16 &&
                    sizeof(float) * potential_fast_smem_floats(a.D, a.T) <= kMaxSmem;
  if (body == kFastBody && !fits) return (int)cudaErrorInvalidValue;
  const bool fast = body == kFastBody || (body == kByShape && fits);
  *used = fast ? kFastBody : kGenericBody;
  if (!fast) return (int)launch_potential_generic(a);
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
