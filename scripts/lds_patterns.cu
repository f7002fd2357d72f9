// Shared-memory load patterns of the rollout kernels' DenseNet body
// (csrc/rollout.cuh, dense_fma), timed in cycles of the SM per warp-wide
// LDS.128 (16 warps an SM, 132 blocks), and the thread-block clusters of
// 2, 3 and 4 blocks of 512 threads that the card holds at once at the
// DenseNet body's shared-memory sizes. Card only:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o lds_patterns scripts/lds_patterns.cu && ./lds_patterns
#include <cstdio>
#include <cuda_runtime.h>

template <int MODE>
__global__ void __launch_bounds__(512, 1) lds_kernel(float* out, int iters, long long* cyc) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) sm[i] = (float)i;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int off;
  if (MODE == 0) off = 0;                       // all lanes one float4
  else if (MODE == 1) off = 4 * (lane & 3);     // 4 parts, part = lane % 4 (adjacent float4s)
  else if (MODE == 2) off = 4 * (lane >> 3);    // 4 parts, part = lane / 8
  else if (MODE == 3) off = 4 * (lane & 7);     // 8 parts, part = lane % 8
  else if (MODE == 4) off = 4 * (lane >> 2);    // 8 parts, part = lane / 4
  else off = 4 * lane;                          // 32 distinct float4s
  off += 512 * (warp & 3);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(sm + off + 128 * u);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    off ^= 2048;
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

__global__ void cluster_probe() {}

int main() {
  float* out; long long* cyc;
  cudaMalloc(&out, 132 * 512 * 4); cudaMalloc(&cyc, 132 * 8);
  const int iters = 2000;
  const char* names[] = {"one float4 (broadcast)", "4 parts, lane % 4", "4 parts, lane / 8",
                         "8 parts, lane % 8", "8 parts, lane / 4", "32 distinct"};
  auto run = [&](auto kernel, int mode) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
    kernel<<<132, 512, 65536>>>(out, iters, cyc);
    cudaDeviceSynchronize();
    long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
    // 16 warps x iters x 16 LDS.128 per SM
    printf("LDS.128 %-24s %.3f cycles per warp instruction (SM-wide)\n", names[mode],
           (double)c / (16.0 * iters * 16));
  };
  run(lds_kernel<0>, 0); run(lds_kernel<1>, 1); run(lds_kernel<2>, 2);
  run(lds_kernel<3>, 3); run(lds_kernel<4>, 4); run(lds_kernel<5>, 5);
  for (int cl = 2; cl <= 4; ++cl) {
    for (int smem : {221360, 230656}) {
      cudaFuncSetAttribute(cluster_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = cl; attr.val.clusterDim.y = 1; attr.val.clusterDim.z = 1;
      cfg.gridDim = dim3(cl); cfg.blockDim = dim3(512); cfg.dynamicSmemBytes = smem;
      cfg.attrs = &attr; cfg.numAttrs = 1;
      int n = -1;
      cudaError_t e = cudaOccupancyMaxActiveClusters(&n, cluster_probe, &cfg);
      printf("clusters of %d blocks (512 threads, %d bytes of shared memory): %d at once (%s)\n",
             cl, smem, n, cudaGetErrorString(e));
    }
  }
  return 0;
}
