// The sparse parameter-server table: the native row store behind
// paddle_tpu_torch.distributed.ps. A copy of the reference's
// native/ps_table.cc: the same C interface, the same rules and the same
// checkpoint format, so either package loads a table the other saved.
//
// reference capability: paddle/fluid/distributed/ps/table/
// (memory_sparse_table.cc — shard-of-hashmap row store;
//  sparse_sgd_rule.cc — naive/adagrad/adam per-row update rules;
//  ctr_accessor.cc — show/click statistics, decay and shrink).
//
// A C-ABI library driven from Python through ctypes, which releases the
// GIL for every call, so pulls and pushes from loader and trainer threads
// run beside device work. Rows live in striped shards, each a hash map
// into a float arena with a free list, so shrink/decay never invalidates
// other rows.
//
// Row layout (floats):   [emb_dim weights][slot state][meta(4)]
//   rule 0 naive SGD:    slot = 0
//   rule 1 adagrad:      slot = emb_dim          (per-dim grad^2 sum)
//   rule 2 adam:         slot = 2*emb_dim + 2    (m, v, beta1^t, beta2^t)
//   meta: [show, click, unseen_days, step]
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kShards = 16;
constexpr int kMeta = 4;
enum Meta { SHOW = 0, CLICK = 1, UNSEEN = 2, STEP = 3 };
enum Rule { NAIVE = 0, ADAGRAD = 1, ADAM = 2 };

struct Shard {
  std::mutex mu;
  std::unordered_map<uint64_t, uint32_t> index;  // id -> row slot
  std::vector<float> arena;                      // slot * row_len floats
  std::vector<uint32_t> free_slots;
};

struct Table {
  int emb_dim;
  int rule;
  float lr, initial_range, eps, beta1, beta2;
  int slot_len;
  int row_len;
  Shard shards[kShards];

  int shard_of(uint64_t id) const {
    // mix so that low-entropy ids (0,1,2,...) still spread
    uint64_t h = id * 0x9E3779B97F4A7C15ull;
    return static_cast<int>(h >> 60) & (kShards - 1);
  }
};

int slot_len_for(int rule, int emb_dim) {
  switch (rule) {
    case ADAGRAD: return emb_dim;
    case ADAM: return 2 * emb_dim + 2;
    default: return 0;
  }
}

// deterministic per-id init: splitmix64 stream -> uniform[-range, range].
// Determinism matters: a re-pulled never-pushed id must see the same
// weights on every server replica and across save/load.
uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void init_row(const Table* t, uint64_t id, float* row) {
  uint64_t s = id ^ 0xA5A5A5A55A5A5A5Aull;
  for (int d = 0; d < t->emb_dim; ++d) {
    uint64_t r = splitmix64(s);
    // 24 mantissa-ish bits -> [0,1) -> [-range, range)
    float u = static_cast<float>(r >> 40) / static_cast<float>(1ull << 24);
    row[d] = (2.0f * u - 1.0f) * t->initial_range;
  }
  std::memset(row + t->emb_dim, 0,
              sizeof(float) * (t->slot_len + kMeta));
  if (t->rule == ADAM) {
    // beta pow accumulators start at 1 (multiplied per step)
    row[t->emb_dim + 2 * t->emb_dim + 0] = 1.0f;
    row[t->emb_dim + 2 * t->emb_dim + 1] = 1.0f;
  }
}

// returns pointer to the row, creating it when absent (caller holds lock)
float* find_or_create(Table* t, Shard& sh, uint64_t id, bool create) {
  auto it = sh.index.find(id);
  if (it != sh.index.end()) return sh.arena.data() + it->second * t->row_len;
  if (!create) return nullptr;
  uint32_t slot;
  if (!sh.free_slots.empty()) {
    slot = sh.free_slots.back();
    sh.free_slots.pop_back();
  } else {
    slot = static_cast<uint32_t>(sh.index.size() + sh.free_slots.size());
    if ((slot + 1) * static_cast<size_t>(t->row_len) > sh.arena.size())
      sh.arena.resize((slot + 1) * static_cast<size_t>(t->row_len) * 2);
  }
  sh.index.emplace(id, slot);
  float* row = sh.arena.data() + slot * static_cast<size_t>(t->row_len);
  init_row(t, id, row);
  return row;
}

void apply_rule(Table* t, float* row, const float* g) {
  float* w = row;
  float* slot = row + t->emb_dim;
  float* meta = row + t->emb_dim + t->slot_len;
  meta[STEP] += 1.0f;
  switch (t->rule) {
    case NAIVE:
      for (int d = 0; d < t->emb_dim; ++d) w[d] -= t->lr * g[d];
      break;
    case ADAGRAD:
      for (int d = 0; d < t->emb_dim; ++d) {
        slot[d] += g[d] * g[d];
        w[d] -= t->lr * g[d] / (std::sqrt(slot[d]) + t->eps);
      }
      break;
    case ADAM: {
      float* m = slot;
      float* v = slot + t->emb_dim;
      float* pows = slot + 2 * t->emb_dim;
      pows[0] *= t->beta1;
      pows[1] *= t->beta2;
      const float corr1 = 1.0f - pows[0];
      const float corr2 = 1.0f - pows[1];
      for (int d = 0; d < t->emb_dim; ++d) {
        m[d] = t->beta1 * m[d] + (1.0f - t->beta1) * g[d];
        v[d] = t->beta2 * v[d] + (1.0f - t->beta2) * g[d] * g[d];
        const float mhat = m[d] / corr1;
        const float vhat = v[d] / corr2;
        w[d] -= t->lr * mhat / (std::sqrt(vhat) + t->eps);
      }
      break;
    }
  }
}

}  // namespace

extern "C" {

void* pt_ps_table_new(int emb_dim, int rule, float lr, float initial_range,
                      float eps, float beta1, float beta2) {
  if (emb_dim <= 0 || rule < 0 || rule > 2) return nullptr;
  Table* t = new Table();
  t->emb_dim = emb_dim;
  t->rule = rule;
  t->lr = lr;
  t->initial_range = initial_range;
  t->eps = eps;
  t->beta1 = beta1;
  t->beta2 = beta2;
  t->slot_len = slot_len_for(rule, emb_dim);
  t->row_len = emb_dim + t->slot_len + kMeta;
  return t;
}

void pt_ps_table_free(void* h) { delete static_cast<Table*>(h); }

// Gather emb weights for n ids into out[n*emb_dim]. Missing ids are
// initialized (init_on_miss=1) or zero-filled (0). Marks rows as seen.
void pt_ps_table_pull(void* h, const uint64_t* ids, int64_t n, float* out,
                      int init_on_miss) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Shard& sh = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(sh.mu);
    float* row = find_or_create(t, sh, ids[i], init_on_miss != 0);
    if (row) {
      std::memcpy(out + i * t->emb_dim, row, sizeof(float) * t->emb_dim);
      row[t->emb_dim + t->slot_len + UNSEEN] = 0.0f;
    } else {
      std::memset(out + i * t->emb_dim, 0, sizeof(float) * t->emb_dim);
    }
  }
}

// Apply the table's update rule with grads[n*emb_dim]. Duplicate ids apply
// sequentially in order (callers that want pre-aggregation dedup first).
void pt_ps_table_push(void* h, const uint64_t* ids, int64_t n,
                      const float* grads) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Shard& sh = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(sh.mu);
    float* row = find_or_create(t, sh, ids[i], true);
    apply_rule(t, row, grads + i * t->emb_dim);
  }
}

// Raw additive merge into weights (geo-SGD delta application; reference
// memory_sparse_geo_table.cc semantics) — bypasses the optimizer rule.
void pt_ps_table_merge(void* h, const uint64_t* ids, int64_t n,
                       const float* deltas) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Shard& sh = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(sh.mu);
    float* row = find_or_create(t, sh, ids[i], true);
    const float* d = deltas + i * t->emb_dim;
    for (int k = 0; k < t->emb_dim; ++k) row[k] += d[k];
  }
}

// Overwrite weights (checkpoint restore / replica sync).
void pt_ps_table_assign(void* h, const uint64_t* ids, int64_t n,
                        const float* rows) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Shard& sh = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(sh.mu);
    float* row = find_or_create(t, sh, ids[i], true);
    std::memcpy(row, rows + i * t->emb_dim, sizeof(float) * t->emb_dim);
  }
}

// Membership mask (no row creation, no stat mutation): out[i] = 1 iff
// ids[i] has a live row. Drives the Python-side entry-admission gate.
void pt_ps_table_contains(void* h, const uint64_t* ids, int64_t n,
                          uint8_t* out) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Shard& sh = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(sh.mu);
    out[i] = sh.index.count(ids[i]) ? 1 : 0;
  }
}

int64_t pt_ps_table_size(void* h) {
  Table* t = static_cast<Table*>(h);
  int64_t total = 0;
  for (auto& sh : t->shards) {
    std::lock_guard<std::mutex> lk(sh.mu);
    total += static_cast<int64_t>(sh.index.size());
  }
  return total;
}

int64_t pt_ps_table_keys(void* h, uint64_t* out, int64_t cap) {
  Table* t = static_cast<Table*>(h);
  int64_t written = 0;
  for (auto& sh : t->shards) {
    std::lock_guard<std::mutex> lk(sh.mu);
    for (auto& kv : sh.index) {
      if (written >= cap) return written;
      out[written++] = kv.first;
    }
  }
  return written;
}

// CTR statistics (reference ctr_accessor.cc): accumulate show/click.
void pt_ps_table_add_show_click(void* h, const uint64_t* ids, int64_t n,
                                const float* shows, const float* clicks) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Shard& sh = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(sh.mu);
    float* row = find_or_create(t, sh, ids[i], true);
    float* meta = row + t->emb_dim + t->slot_len;
    meta[SHOW] += shows[i];
    meta[CLICK] += clicks[i];
  }
}

// End-of-day decay: show/click *= decay, unseen_days += 1 (reference
// CtrCommonAccessor::UpdateStatAfterSave / shrink bookkeeping).
void pt_ps_table_decay(void* h, float decay) {
  Table* t = static_cast<Table*>(h);
  for (auto& sh : t->shards) {
    std::lock_guard<std::mutex> lk(sh.mu);
    for (auto& kv : sh.index) {
      float* meta = sh.arena.data() + kv.second * t->row_len +
                    t->emb_dim + t->slot_len;
      meta[SHOW] *= decay;
      meta[CLICK] *= decay;
      meta[UNSEEN] += 1.0f;
    }
  }
}

// Evict rows with show < show_threshold AND unseen_days >= unseen_threshold.
// Returns evicted count. Freed slots are reused by later inserts.
int64_t pt_ps_table_shrink(void* h, float show_threshold,
                           float unseen_threshold) {
  Table* t = static_cast<Table*>(h);
  int64_t removed = 0;
  for (auto& sh : t->shards) {
    std::lock_guard<std::mutex> lk(sh.mu);
    for (auto it = sh.index.begin(); it != sh.index.end();) {
      float* meta = sh.arena.data() + it->second * t->row_len +
                    t->emb_dim + t->slot_len;
      if (meta[SHOW] < show_threshold && meta[UNSEEN] >= unseen_threshold) {
        sh.free_slots.push_back(it->second);
        it = sh.index.erase(it);
        ++removed;
      } else {
        ++it;
      }
    }
  }
  return removed;
}

// Binary checkpoint: header + (id, full row) records. Full rows (incl.
// optimizer slots and meta) so training resumes exactly. All shard locks
// are held for the duration — pulls/pushes from other threads wait, and
// the header count always matches the records written (a count taken
// before iteration can race a concurrent push/shrink). Every fwrite is
// checked: a short write (disk full) must NOT report success.
int pt_ps_table_save(void* h, const char* path) {
  Table* t = static_cast<Table*>(h);
  // write to a temp file and rename on success: a failed save (disk
  // full) must not truncate the previous checkpoint at `path`
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  for (auto& sh : t->shards) sh.mu.lock();  // fixed order: no deadlock
  int64_t count = 0;
  for (auto& sh : t->shards) count += static_cast<int64_t>(sh.index.size());
  const char magic[4] = {'P', 'T', 'P', 'S'};
  int32_t version = 1;
  bool ok = std::fwrite(magic, 1, 4, f) == 4 &&
            std::fwrite(&version, sizeof(version), 1, f) == 1 &&
            std::fwrite(&t->emb_dim, sizeof(t->emb_dim), 1, f) == 1 &&
            std::fwrite(&t->rule, sizeof(t->rule), 1, f) == 1 &&
            std::fwrite(&t->row_len, sizeof(t->row_len), 1, f) == 1 &&
            std::fwrite(&count, sizeof(count), 1, f) == 1;
  for (auto& sh : t->shards) {
    if (!ok) break;
    for (auto& kv : sh.index) {
      if (std::fwrite(&kv.first, sizeof(uint64_t), 1, f) != 1 ||
          std::fwrite(sh.arena.data() + kv.second * t->row_len,
                      sizeof(float), t->row_len, f) !=
              static_cast<size_t>(t->row_len)) {
        ok = false;
        break;
      }
    }
  }
  for (int i = kShards - 1; i >= 0; --i) t->shards[i].mu.unlock();
  if (std::fclose(f) != 0) ok = false;
  if (ok && std::rename(tmp.c_str(), path) != 0) ok = false;
  if (!ok) std::remove(tmp.c_str());
  return ok ? 0 : -4;
}

int pt_ps_table_load(void* h, const char* path) {
  Table* t = static_cast<Table*>(h);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  int32_t version;
  int emb_dim, rule, row_len;
  int64_t count;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "PTPS", 4) != 0 ||
      std::fread(&version, sizeof(version), 1, f) != 1 || version != 1 ||
      std::fread(&emb_dim, sizeof(emb_dim), 1, f) != 1 ||
      std::fread(&rule, sizeof(rule), 1, f) != 1 ||
      std::fread(&row_len, sizeof(row_len), 1, f) != 1 ||
      std::fread(&count, sizeof(count), 1, f) != 1 ||
      emb_dim != t->emb_dim || rule != t->rule || row_len != t->row_len) {
    std::fclose(f);
    return -2;
  }
  std::vector<float> row(t->row_len);
  for (int64_t i = 0; i < count; ++i) {
    uint64_t id;
    if (std::fread(&id, sizeof(id), 1, f) != 1 ||
        std::fread(row.data(), sizeof(float), t->row_len, f) !=
            static_cast<size_t>(t->row_len)) {
      std::fclose(f);
      return -3;
    }
    Shard& sh = t->shards[t->shard_of(id)];
    std::lock_guard<std::mutex> lk(sh.mu);
    float* dst = find_or_create(t, sh, id, true);
    std::memcpy(dst, row.data(), sizeof(float) * t->row_len);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
