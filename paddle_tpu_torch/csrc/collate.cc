// Parallel batch collation for the port's DataLoader: a copy of
// native/collate.cc's pt_collate_stack. Stacking N samples into one
// contiguous batch is a pure memcpy problem, so it runs in C++ threads with
// the interpreter lock released (ctypes releases it for the whole call).
// Built by g++ at first use (paddle_tpu_torch/io/_collate.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void copy_range(const void** srcs, int64_t item_bytes, char* dst, int64_t lo,
                int64_t hi) {
  for (int64_t i = lo; i < hi; ++i)
    std::memcpy(dst + i * item_bytes, srcs[i], static_cast<size_t>(item_bytes));
}

}  // namespace

extern "C" {

// Stack n equal-sized items into dst (contiguous). Threads chosen so each
// copies >= ~1 MiB: below that the spawn cost dominates.
void pt_collate_stack(const void** srcs, int64_t n, int64_t item_bytes,
                      void* dst, int max_threads) {
  char* out = static_cast<char*>(dst);
  int64_t total = n * item_bytes;
  int nt = max_threads > 0 ? max_threads
                           : static_cast<int>(std::thread::hardware_concurrency());
  nt = static_cast<int>(std::min<int64_t>(nt, std::max<int64_t>(total >> 20, 1)));
  nt = std::max(1, std::min<int>(nt, static_cast<int>(n)));
  if (nt == 1) {
    copy_range(srcs, item_bytes, out, 0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(copy_range, srcs, item_bytes, out, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
