// The device stamp of a refinement step (diffdope_tpu_torch/trace.py) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: it times the stages of one captured step on the
// device's own clock, where a profiler cannot tell which stage a graph
// replay's kernels belong to.  One thread reads %globaltimer (ns) and writes
// it into stamps[row, point], row the step's history row counter (read on
// the device, as the histories are written) plus `delta`, so a graph replays
// it at the row of each step.  Bound: one 8-byte store; its cost is the
// launch, a graph node of ~2 us, paid at each of the step's points.  A row
// outside [0, rows) writes nothing.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* stamps, const long long* row, int delta,
                             int point, int points, int rows) {
  const long long r = row[0] + delta;
  if (r < 0 || r >= rows) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  stamps[r * points + point] = (long long)now;
}

}  // namespace

// stamps (rows, points) int64; row (1,) int64
extern "C" int dd_stamp(long long* stamps, const long long* row, int delta, int point,
                        int points, int rows, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(stamps, row, delta, point, points,
                                                  rows);
  return (int)cudaGetLastError();
}
