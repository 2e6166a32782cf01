// CUDA device code compiled for the host: one std::thread per CUDA thread of
// a block, a block's threads met at __syncthreads by a barrier, the blocks of
// a grid run one after another by the same threads, shared memory one buffer.
// The stand-in of jpeg_decode.cu (tests/torch_port_jpeg_standin.py) compiles
// that file's kernels under it; tests/test_torch_port_batch_norm_standin.py
// the whole of batch_norm.cu, its launches rewritten.
#include <pthread.h>
#include <stdint.h>
#include <string.h>

#include <thread>
#include <vector>

struct dim3v {
  unsigned x = 1, y = 1, z = 1;
};
struct uint4 {
  unsigned x, y, z, w;
};
static dim3v blockDim;
static thread_local dim3v blockIdx, threadIdx;
static pthread_barrier_t g_barrier;
#define __syncthreads() pthread_barrier_wait(&g_barrier)
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(n)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
// each operation rounded on its own: the file is built with -ffp-contract=off
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline int min(int a, int b) { return a < b ? a : b; }
static inline int max(int a, int b) { return a > b ? a : b; }
alignas(16) uint8_t smem[240 * 1024];  // the block's dynamic shared memory

// body() run by `threads` threads for each block of the (gx, gy) grid
template <class F>
void launch(unsigned gx, unsigned gy, unsigned threads, F body) {
  blockDim.x = threads;
  pthread_barrier_init(&g_barrier, nullptr, threads);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([=, &body] {
      threadIdx.x = t;
      for (unsigned by = 0; by < gy; ++by)
        for (unsigned bx = 0; bx < gx; ++bx) {
          blockIdx.x = bx;
          blockIdx.y = by;
          body();
          pthread_barrier_wait(&g_barrier);  // the block ends before the next one starts
        }
    });
  for (auto& t : pool) t.join();
  pthread_barrier_destroy(&g_barrier);
}
