// Stage marks: one-thread kernels that stamp the device's clock between
// the stages of a captured step.
//
// A host range (record_function, NVTX) opened while a CUDA graph is being
// captured is not replayed: only work on the device survives capture. So
// the compiled step (train/compiled.py) marks the boundaries of its
// stages with these kernels, captured into each graph between the
// stages' own work. Mark j of a graph writes %globaltimer (ns) into slot
// j of that graph's buffer when the work before it on the stream is done;
// the interval between two marks is named after the one that ends it.
//
// One kernel per stage, so that a profiler's record names the stage: the
// kernel of stage s is rain_mark_<s>. RAIN_MARKS lists the stages in the
// order of rain_tpu_torch/train/marks.py:STAGES, which passes a stage's
// index here (tests/test_torch_stage_marks.py holds the two lists equal).

#include <cstdint>
#include <cuda_runtime.h>

#define RAIN_MARKS(X) \
  X(begin)            \
  X(preprocess)       \
  X(depth_sort)       \
  X(expand_B1)        \
  X(tile_sort_gather) \
  X(tile_ranges)      \
  X(composite_B3)     \
  X(assemble)         \
  X(loss)             \
  X(loss_bwd)         \
  X(composite_bwd_B4) \
  X(reduce_B2)        \
  X(grads)            \
  X(densify_stats)    \
  X(adam)             \
  X(round)            \
  X(reset)

#define RAIN_MARK_KERNEL(stage)                                       \
  extern "C" __global__ void rain_mark_##stage(uint64_t* slot) {     \
    uint64_t t;                                                       \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));            \
    *slot = t;                                                        \
  }
RAIN_MARKS(RAIN_MARK_KERNEL)

namespace {

#define RAIN_MARK_ENTRY(stage) (const void*)rain_mark_##stage,
const void* const kMarks[] = {RAIN_MARKS(RAIN_MARK_ENTRY)};
constexpr int kCount = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Loads every mark kernel on `device` (cudaFuncGetAttributes loads a
// lazily loaded kernel), so that no mark is first loaded inside a stream
// capture. Returns the first cudaError_t, or 0.
extern "C" int rain_mark_load(int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < kCount; ++i) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kMarks[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches the mark of stage `which` (its index in RAIN_MARKS), one
// thread, writing into *slot, on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
extern "C" int rain_mark(int device, void* stream, int which, void* slot) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (which < 0 || which >= kCount) return (int)cudaErrorInvalidValue;
  void* args[] = {&slot};
  return (int)cudaLaunchKernel(kMarks[which], dim3(1), dim3(1), args, 0,
                               (cudaStream_t)stream);
}
