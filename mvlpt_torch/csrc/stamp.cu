// The spans' stamps (utils/profiler.py) through a C entry: the kernel is
// stamp.cuh's, which the attention half-blocks' launchers also launch
// around their cores.
#include "stamp.cuh"

extern "C" int mvlpt_stamp(void* table, const void* row, int width, int col, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)table, (const long long*)row,
                                                  width, col);
  return (int)cudaGetLastError();
}

extern "C" const char* mvlpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
