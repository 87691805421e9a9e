// launch_floor: an empty kernel, the yardstick of launch latency.
//
// No TPU kernel corresponds to it and no path of the package launches it.
// chip_smoke.py captures it alone in a CUDA graph and times its replays
// as it times every kernel, so each kernel's reading can be held against
// the least time any launch takes on the card.
#include <cuda_runtime.h>

namespace repro_torch {

__global__ void empty_kernel() {}

}  // namespace repro_torch

extern "C" int repro_launch_floor(void* stream) {
  repro_torch::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
