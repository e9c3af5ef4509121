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
//
// stamp.cu launches it for the spans; a kernel's launcher launches it
// itself for marks around one of its kernels (Marks: the attention
// half-blocks' cores), so the span holds that kernel alone.
#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* table, const long long* row, int width, int col) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  table[(row ? row[0] : 0LL) * width + col] = (long long)t;
}

// The two slots (col, col + 1) of a span whose stamps a launcher writes
// around its kernel; a null table: no marks, nothing launched.
struct Marks {
  long long* table;
  const long long* row;
  int width, col;
};

// Stamp the span's start (k = 0) or end (k = 1) on stream st.
inline cudaError_t mark(const Marks& m, int k, cudaStream_t st) {
  if (m.table == nullptr) return cudaSuccess;
  stamp_kernel<<<1, 1, 0, st>>>(m.table, m.row, m.width, m.col + k);
  return cudaGetLastError();
}

}  // namespace
