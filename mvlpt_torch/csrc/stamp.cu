// The device clock of the port's spans (utils/profiler.py): one thread
// writes the GPU's global nanosecond timer into a slot of an int64 table
// when its stream reaches it, i.e. once the work enqueued before it is
// done. A span's start and end are two such stamps.
//
// The slot is table[row * width + col], with the row read on the device
// from ``row`` (a step captured into a CUDA graph passes the windowed
// step's index, so each replay writes its own row) or 0 when ``row`` is
// null. In a graph a stamp is a kernel node, which costs the replay less
// than a timing event's record node does.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* table, const long long* row, int width, int col) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  table[(row ? row[0] : 0LL) * width + col] = (long long)t;
}

}  // namespace

extern "C" int mvlpt_stamp(void* table, const void* row, int width, int col, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)table, (const long long*)row,
                                                  width, col);
  return (int)cudaGetLastError();
}

extern "C" const char* mvlpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
