// A stamp of the card's clock, written by the card into a tensor.
//
// Replaces no TPU kernel: it is instrumentation.  A CUDA event recorded
// inside a captured CUDA graph is the same event at every replay, so with
// several replays of one graph queued an event's elapsed time reads another
// batch's time, or is not ready.  A kernel that writes the clock into the
// batch's own output instead gives every replay its own stamps, copied to
// the host with the batch's answers.
//
// One thread of one block reads the card's global nanosecond timer
// (%globaltimer) and stores it to out[0].  Launched on a stream, it runs
// once the work enqueued before it there has finished and before the work
// after it starts, so two stamps bracket the kernels between them.  It is
// bound by its launch latency (a few microseconds); it reads nothing and
// writes 8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void card_stamp_kernel(int64_t* out) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = static_cast<int64_t>(t);
}

}  // namespace

// out: device pointer to one int64; stream: a cudaStream_t.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int card_stamp_run(void* out, void* stream) {
  card_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
