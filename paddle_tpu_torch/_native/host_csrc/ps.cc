// Host-side parameter server: dense + sparse tables with in-table optimizers,
// served over TCP to trainer processes.
//
// The port's own copy of paddle_tpu/_native/csrc/ps.cc (the JAX package's
// table server), built into build/libpaddle_tpu_torch_host.so by
// paddle_tpu_torch/_native/host.py. The wire protocol and the row
// initialisation are the same, so a trainer of either package reads the
// same rows for the same key and seed. Paddle's PS core
// (paddle/fluid/distributed/ps/: BrpcPsServer/BrpcPsClient, ps/service/
// brpc_ps_server.cc, brpc_ps_client.h:137) becomes a framed-TCP server;
// ps/table/common_dense_table.cc and memory_sparse_table.cc become
// DenseTable/SparseTable below, keeping the key design points:
//   * sparse rows are created lazily on first pull (CTR-style feasign space),
//   * the optimizer runs inside the table on push (server-side SGD/Adagrad/
//     Adam, paddle's table/sparse_sgd_rule.cc),
//   * tables are sharded internally for concurrent access (paddle shards
//     by feasign across "buckets"; we shard the hash map + mutex),
//   * save/load to a directory, one file per table (table/io semantics).
// The dense math of a trainer lives on the card; this server holds the
// embedding tables of the sparse models (Wide&Deep/DeepFM), which exceed
// device memory.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "net.h"

namespace ps {

using ptnet::Reader;
using ptnet::Writer;

enum Cmd : uint8_t {
  CMD_CREATE_TABLE = 1,
  CMD_PULL_DENSE = 2,
  CMD_PUSH_DENSE = 3,
  CMD_SET_DENSE = 4,
  CMD_PULL_SPARSE = 5,
  CMD_PUSH_SPARSE = 6,
  CMD_SAVE = 7,
  CMD_LOAD = 8,
  CMD_BARRIER = 9,
  CMD_STOP = 10,
  CMD_TABLE_SIZE = 11,
  CMD_PING = 12,
  CMD_PUSH_SHOW_CLICK = 13,  // CTR lifecycle: show/click counters
  CMD_SHRINK = 14,           // decay + age + evict (ctr_accessor::Shrink)
  CMD_PULL_META = 15,        // per-key (show, click, unseen_days) for tests
  CMD_SET_SPILL = 16,        // enable disk spill (ssd_sparse_table equiv.)
  CMD_SPILL_COLD = 17,       // move unseen>N rows to the spill file
  CMD_SPILLED_SIZE = 18,     // rows currently on disk
  CMD_GRAPH_ADD_EDGES = 19,  // graph table (common_graph_table equiv.)
  CMD_GRAPH_SAMPLE = 20,     // weighted neighbor sampling
  CMD_GRAPH_DEGREE = 21,
};

// OPT_SUM: raw delta-apply (w += g) — the server side of geo-SGD
// (reference memory_sparse_geo_table.cc: trainers train locally and push
// accumulated deltas; the table just merges them).
enum Opt : uint8_t { OPT_SGD = 0, OPT_ADAGRAD = 1, OPT_ADAM = 2, OPT_SUM = 3 };

enum Status : uint8_t { ST_OK = 0, ST_ERR = 1 };

// splitmix64 — deterministic per-key init rng (lazy rows reproduce across
// save/load-free restarts, mirroring the reference's seeded init rules).
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

static inline float unit_uniform(uint64_t h) {
  // [0,1) from the top 24 bits
  return static_cast<float>(h >> 40) / static_cast<float>(1ULL << 24);
}

struct TableConfig {
  uint8_t kind = 1;  // 0 dense, 1 sparse
  int32_t dim = 8;
  int64_t dense_size = 0;
  uint8_t opt = OPT_SGD;
  float lr = 0.01f;
  float init_range = 0.05f;
  uint64_t seed = 0;
  // adam hyperparams (fixed defaults, as in reference sparse_adam rule)
  float beta1 = 0.9f, beta2 = 0.999f, eps = 1e-8f;
};

static int state_slots(uint8_t opt) {
  switch (opt) {
    case OPT_ADAGRAD: return 1;  // accumulator
    case OPT_ADAM: return 2;     // m, v
    default: return 0;           // SGD and SUM (geo) are stateless
  }
}

// One sparse row: [step][CTR meta][values dim][state dim*slots].
// CTR meta mirrors the reference's CtrCommonFeatureValue
// (ps/table/ctr_accessor.h): show/click counters decayed by Shrink, and
// unseen_days driving eviction of stale features.
struct SparseEntry {
  uint32_t step = 0;
  float show = 0.0f;
  float click = 0.0f;
  uint32_t unseen_days = 0;
  std::vector<float> data;  // dim * (1 + slots)
};

class SparseTable {
 public:
  explicit SparseTable(const TableConfig& cfg) : cfg_(cfg) {}

  static constexpr int kShards = 16;

  void pull(const uint64_t* keys, int64_t n, float* out) {
    const int dim = cfg_.dim;
    for (int64_t i = 0; i < n; ++i) {
      uint64_t k = keys[i];
      Shard& s = shard(k);
      std::lock_guard<std::mutex> g(s.mu);
      SparseEntry& e = fetch_or_init(s, k);
      e.unseen_days = 0;
      std::memcpy(out + i * dim, e.data.data(), dim * sizeof(float));
    }
  }

  void push(const uint64_t* keys, int64_t n, const float* grads) {
    const int dim = cfg_.dim;
    for (int64_t i = 0; i < n; ++i) {
      uint64_t k = keys[i];
      Shard& s = shard(k);
      std::lock_guard<std::mutex> g(s.mu);
      SparseEntry& e = fetch_or_init(s, k);
      e.unseen_days = 0;
      apply(&e, grads + i * dim);
    }
  }

  int64_t size() const {
    int64_t t = 0;
    for (const Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      t += static_cast<int64_t>(s.map.size());
    }
    return t;
  }

  void push_show_click(const uint64_t* keys, int64_t n, const float* shows,
                       const float* clicks) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard(keys[i]);
      std::lock_guard<std::mutex> g(s.mu);
      SparseEntry& e = fetch_or_init(s, keys[i]);
      e.show += shows[i];
      e.click += clicks[i];
      e.unseen_days = 0;
    }
  }

  void pull_meta(const uint64_t* keys, int64_t n, float* show, float* click,
                 int32_t* unseen) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard(keys[i]);
      std::lock_guard<std::mutex> g(s.mu);
      auto it = s.map.find(keys[i]);
      if (it == s.map.end()) {
        show[i] = click[i] = 0.0f;
        unseen[i] = -1;  // not present
      } else {
        show[i] = it->second.show;
        click[i] = it->second.click;
        unseen[i] = static_cast<int32_t>(it->second.unseen_days);
      }
    }
  }

  // ---- disk spill (reference ps/table/ssd_sparse_table.cc, rocksdb) ----
  // Cold rows move to an append-only spill file; RAM keeps only a
  // key->offset index (16B/row vs a full row) — the bounded-memory story
  // behind the reference's "100B feature" tables. A spilled row is
  // restored transparently on its next pull/push.

  bool set_spill(const std::string& path) {
    std::lock_guard<std::mutex> g(spill_mu_);
    if (!spill_index_.empty())
      return false;  // rows live only on disk: refusing protects them
    if (spill_f_) fclose(spill_f_);
    spill_path_ = path;
    spill_dead_ = 0;
    spill_f_ = fopen(path.c_str(), "wb+");
    return spill_f_ != nullptr;
  }

  // Rewrite the spill file keeping only indexed (live) records. The file
  // is append-only and every restore leaves a dead record behind; without
  // compaction long-running daily maintenance grows it without bound
  // (ADVICE r2). Caller holds spill_mu_.
  void compact_spill_locked() {
    const size_t row = cfg_.dim * (1 + state_slots(cfg_.opt));
    const size_t rec = 24 + row * sizeof(float);
    std::string tmp = spill_path_ + ".compact";
    FILE* nf = fopen(tmp.c_str(), "wb+");
    if (!nf) return;
    std::vector<char> buf(rec);
    std::unordered_map<uint64_t, uint64_t> fresh;
    fresh.reserve(spill_index_.size());
    for (const auto& kv : spill_index_) {
      fseek(spill_f_, static_cast<long>(kv.second), SEEK_SET);
      if (fread(buf.data(), 1, rec, spill_f_) != rec ||
          fwrite(buf.data(), 1, rec, nf) != rec) {
        // ANY read/write failure aborts: the old (bloated but complete)
        // file keeps every row; losing bloat is better than losing rows
        fclose(nf);
        remove(tmp.c_str());
        return;
      }
      fresh[kv.first] = static_cast<uint64_t>(ftell(nf)) - rec;
    }
    fflush(nf);
    if (rename(tmp.c_str(), spill_path_.c_str()) != 0) {
      fclose(nf);
      remove(tmp.c_str());
      return;  // old file + index remain valid
    }
    // nf IS the renamed file's handle — adopting it avoids a reopen that
    // could fail and strand a non-empty index with no backing file
    fclose(spill_f_);
    spill_f_ = nf;
    spill_index_ = std::move(fresh);
    spill_dead_ = 0;
  }

  int64_t spill_cold(int32_t max_unseen_days) {
    // COMPARES unseen_days without aging it: shrink() owns the day tick
    // (running both daily must not age rows twice). Spill-only maintenance
    // should pair this with an age-only shrink (negative threshold).
    // lock order is ALWAYS shard -> spill (restore_from_spill runs under a
    // shard lock), so the spill mutex is taken per-row inside the shard loop
    const size_t row = cfg_.dim * (1 + state_slots(cfg_.opt));
    {
      std::lock_guard<std::mutex> gs(spill_mu_);
      if (!spill_f_) return -1;
    }
    int64_t spilled = 0;
    for (Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      for (auto it = s.map.begin(); it != s.map.end();) {
        SparseEntry& e = it->second;
        if (e.unseen_days > static_cast<uint32_t>(max_unseen_days)) {
          std::lock_guard<std::mutex> gs(spill_mu_);
          if (!spill_f_) return spilled;
          fseek(spill_f_, 0, SEEK_END);
          uint64_t off = static_cast<uint64_t>(ftell(spill_f_));
          fwrite(&it->first, 8, 1, spill_f_);
          fwrite(&e.step, 4, 1, spill_f_);
          fwrite(&e.show, 4, 1, spill_f_);
          fwrite(&e.click, 4, 1, spill_f_);
          fwrite(&e.unseen_days, 4, 1, spill_f_);
          fwrite(e.data.data(), sizeof(float), row, spill_f_);
          spill_index_[it->first] = off;
          it = s.map.erase(it);
          ++spilled;
        } else {
          ++it;
        }
      }
    }
    std::lock_guard<std::mutex> gs(spill_mu_);
    if (spill_f_) {
      fflush(spill_f_);
      // opportunistic compaction at daily-maintenance cadence: rewrite
      // when dead records outnumber live ones (and there is real bloat)
      if (spill_dead_ > spill_index_.size() && spill_dead_ > 1024)
        compact_spill_locked();
    }
    return spilled;
  }

  int64_t spilled_size() const {
    std::lock_guard<std::mutex> g(spill_mu_);
    return static_cast<int64_t>(spill_index_.size());
  }

  // Restore `key` from disk into `e`; true on hit. Caller holds shard lock.
  bool restore_from_spill(uint64_t key, SparseEntry* e) {
    const size_t row = cfg_.dim * (1 + state_slots(cfg_.opt));
    std::lock_guard<std::mutex> g(spill_mu_);
    auto it = spill_index_.find(key);
    if (!spill_f_ || it == spill_index_.end()) return false;
    fseek(spill_f_, static_cast<long>(it->second), SEEK_SET);
    uint64_t k = 0;
    e->data.resize(row);
    if (fread(&k, 8, 1, spill_f_) != 1 || k != key ||
        fread(&e->step, 4, 1, spill_f_) != 1 ||
        fread(&e->show, 4, 1, spill_f_) != 1 ||
        fread(&e->click, 4, 1, spill_f_) != 1 ||
        fread(&e->unseen_days, 4, 1, spill_f_) != 1 ||
        fread(e->data.data(), sizeof(float), row, spill_f_) != row)
      return false;
    spill_index_.erase(it);  // the live copy moves back to RAM
    ++spill_dead_;           // its file record is now dead (compaction input)
    return true;
  }

  // One "day" tick (reference CtrCommonAccessor::Shrink): decay show/click,
  // age every row, evict rows whose score dropped below `threshold` AND
  // that have not been touched for more than `max_unseen_days` ticks.
  // Returns the number of evicted rows.
  int64_t shrink(float threshold, int32_t max_unseen_days,
                 float show_decay = 0.98f, float show_coeff = 1.0f,
                 float click_coeff = 1.0f) {
    int64_t evicted = 0;
    for (Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      for (auto it = s.map.begin(); it != s.map.end();) {
        SparseEntry& e = it->second;
        e.show *= show_decay;
        e.click *= show_decay;
        e.unseen_days += 1;
        float score = show_coeff * e.show + click_coeff * e.click;
        if (score < threshold &&
            e.unseen_days > static_cast<uint32_t>(max_unseen_days)) {
          it = s.map.erase(it);
          ++evicted;
        } else {
          ++it;
        }
      }
    }
    return evicted;
  }

  // format v2: magic header guards against misparsing v1 (pre-CTR) files
  static constexpr uint32_t kMagic = 0x50545332;  // "PTS2"

  bool save(FILE* f) const {
    // quiesce the whole table: all shard locks (in order), then the spill
    // lock — concurrent pulls could otherwise restore a spilled row
    // between the count and the walk, corrupting the row-count header
    std::vector<std::unique_lock<std::mutex>> guards;
    guards.reserve(kShards);
    for (const Shard& s : shards_) guards.emplace_back(s.mu);
    std::lock_guard<std::mutex> g(spill_mu_);
    fwrite(&kMagic, 4, 1, f);
    int64_t n = 0;
    for (const Shard& s : shards_) n += static_cast<int64_t>(s.map.size());
    n += static_cast<int64_t>(spill_index_.size());
    fwrite(&n, 8, 1, f);
    const size_t row = cfg_.dim * (1 + state_slots(cfg_.opt));
    for (const Shard& s : shards_) {
      for (const auto& kv : s.map) {
        fwrite(&kv.first, 8, 1, f);
        fwrite(&kv.second.step, 4, 1, f);
        fwrite(&kv.second.show, 4, 1, f);
        fwrite(&kv.second.click, 4, 1, f);
        fwrite(&kv.second.unseen_days, 4, 1, f);
        fwrite(kv.second.data.data(), sizeof(float), row, f);
      }
    }
    // checkpoints are fully materialized: spilled rows are read back from
    // the spill file so a load never depends on it
    if (spill_f_) {
      for (const auto& kv : spill_index_) {
        fseek(spill_f_, static_cast<long>(kv.second), SEEK_SET);
        uint64_t k;
        SparseEntry e;
        e.data.resize(row);
        if (fread(&k, 8, 1, spill_f_) != 1 ||
            fread(&e.step, 4, 1, spill_f_) != 1 ||
            fread(&e.show, 4, 1, spill_f_) != 1 ||
            fread(&e.click, 4, 1, spill_f_) != 1 ||
            fread(&e.unseen_days, 4, 1, spill_f_) != 1 ||
            fread(e.data.data(), sizeof(float), row, spill_f_) != row)
          return false;
        fwrite(&k, 8, 1, f);
        fwrite(&e.step, 4, 1, f);
        fwrite(&e.show, 4, 1, f);
        fwrite(&e.click, 4, 1, f);
        fwrite(&e.unseen_days, 4, 1, f);
        fwrite(e.data.data(), sizeof(float), row, f);
      }
    }
    return true;
  }

  bool load(FILE* f) {
    {
      // the checkpoint is fully materialized (save reads spilled rows
      // back), so stale disk offsets must not survive a restore — they
      // would resurrect pre-checkpoint weights after a later eviction
      std::lock_guard<std::mutex> g(spill_mu_);
      spill_index_.clear();
    }
    uint32_t magic = 0;
    if (fread(&magic, 4, 1, f) != 1 || magic != kMagic)
      return false;  // clean failure on old/foreign files, not corruption
    int64_t n = 0;
    if (fread(&n, 8, 1, f) != 1) return false;
    const size_t row = cfg_.dim * (1 + state_slots(cfg_.opt));
    for (int64_t i = 0; i < n; ++i) {
      uint64_t k;
      SparseEntry e;
      e.data.resize(row);
      if (fread(&k, 8, 1, f) != 1) return false;
      if (fread(&e.step, 4, 1, f) != 1) return false;
      if (fread(&e.show, 4, 1, f) != 1) return false;
      if (fread(&e.click, 4, 1, f) != 1) return false;
      if (fread(&e.unseen_days, 4, 1, f) != 1) return false;
      if (fread(e.data.data(), sizeof(float), row, f) != row) return false;
      Shard& s = shard(k);
      std::lock_guard<std::mutex> g(s.mu);
      s.map[k] = std::move(e);
    }
    return true;
  }

  const TableConfig& config() const { return cfg_; }

 private:
  struct Shard {
    mutable std::mutex mu;
    std::unordered_map<uint64_t, SparseEntry> map;
  };

  Shard& shard(uint64_t key) {
    return shards_[splitmix64(key) % kShards];
  }

  SparseEntry& fetch_or_init(Shard& s, uint64_t key) {
    auto it = s.map.find(key);
    if (it != s.map.end()) return it->second;
    SparseEntry spilled;
    if (restore_from_spill(key, &spilled))
      return s.map.emplace(key, std::move(spilled)).first->second;
    SparseEntry e;
    e.data.assign(cfg_.dim * (1 + state_slots(cfg_.opt)), 0.0f);
    uint64_t h = splitmix64(key ^ cfg_.seed);
    for (int d = 0; d < cfg_.dim; ++d) {
      h = splitmix64(h);
      e.data[d] = (unit_uniform(h) * 2.0f - 1.0f) * cfg_.init_range;
    }
    return s.map.emplace(key, std::move(e)).first->second;
  }

  void apply(SparseEntry* e, const float* g) {
    const int dim = cfg_.dim;
    float* w = e->data.data();
    switch (cfg_.opt) {
      case OPT_SGD:
        for (int d = 0; d < dim; ++d) w[d] -= cfg_.lr * g[d];
        break;
      case OPT_SUM:  // geo: merge a trainer's local delta
        for (int d = 0; d < dim; ++d) w[d] += g[d];
        break;
      case OPT_ADAGRAD: {
        float* acc = w + dim;
        for (int d = 0; d < dim; ++d) {
          acc[d] += g[d] * g[d];
          w[d] -= cfg_.lr * g[d] / (std::sqrt(acc[d]) + cfg_.eps);
        }
        break;
      }
      case OPT_ADAM: {
        float* m = w + dim;
        float* v = w + 2 * dim;
        e->step += 1;
        const float b1 = cfg_.beta1, b2 = cfg_.beta2;
        const float bc1 = 1.0f - std::pow(b1, static_cast<float>(e->step));
        const float bc2 = 1.0f - std::pow(b2, static_cast<float>(e->step));
        for (int d = 0; d < dim; ++d) {
          m[d] = b1 * m[d] + (1 - b1) * g[d];
          v[d] = b2 * v[d] + (1 - b2) * g[d] * g[d];
          w[d] -= cfg_.lr * (m[d] / bc1) / (std::sqrt(v[d] / bc2) + cfg_.eps);
        }
        break;
      }
    }
  }

  TableConfig cfg_;
  Shard shards_[kShards];
  mutable std::mutex spill_mu_;
  FILE* spill_f_ = nullptr;
  std::string spill_path_;
  size_t spill_dead_ = 0;  // dead (restored) records in the spill file
  std::unordered_map<uint64_t, uint64_t> spill_index_;  // key -> file offset
};

class DenseTable {
 public:
  explicit DenseTable(const TableConfig& cfg) : cfg_(cfg) {
    w_.assign(cfg.dense_size, 0.0f);
    state_.assign(cfg.dense_size * state_slots(cfg.opt), 0.0f);
    uint64_t h = splitmix64(cfg.seed ^ 0xD15EA5E5ULL);
    for (int64_t i = 0; i < cfg.dense_size; ++i) {
      h = splitmix64(h);
      w_[i] = (unit_uniform(h) * 2.0f - 1.0f) * cfg.init_range;
    }
  }

  // Range ops: large tables move as <=64MB chunks (client-side chunking).
  // A logical optimizer step spans the chunks of one push sweep; the Adam
  // step counter ticks on the off==0 chunk (chunks arrive in order from
  // one client; cross-client interleaving has hogwild semantics, as the
  // reference's async dense push does).
  void pull(float* out, int64_t off, int64_t len) {
    std::lock_guard<std::mutex> g(mu_);
    std::memcpy(out, w_.data() + off, len * sizeof(float));
  }

  void set(const float* vals, int64_t off, int64_t len) {
    std::lock_guard<std::mutex> g(mu_);
    std::memcpy(w_.data() + off, vals, len * sizeof(float));
  }

  bool range_ok(int64_t off, int64_t len) const {
    return off >= 0 && len >= 0 &&
           off + len <= static_cast<int64_t>(w_.size());
  }

  void push(const float* g, int64_t off, int64_t len) {
    std::lock_guard<std::mutex> gd(mu_);
    const int64_t n = static_cast<int64_t>(w_.size());
    float* w = w_.data() + off;
    switch (cfg_.opt) {
      case OPT_SGD:
        for (int64_t i = 0; i < len; ++i) w[i] -= cfg_.lr * g[i];
        break;
      case OPT_SUM:  // geo: merge a trainer's local delta
        for (int64_t i = 0; i < len; ++i) w[i] += g[i];
        break;
      case OPT_ADAGRAD: {
        float* acc = state_.data() + off;
        for (int64_t i = 0; i < len; ++i) {
          acc[i] += g[i] * g[i];
          w[i] -= cfg_.lr * g[i] / (std::sqrt(acc[i]) + cfg_.eps);
        }
        break;
      }
      case OPT_ADAM: {
        float* m = state_.data() + off;
        float* v = state_.data() + n + off;
        if (off == 0) step_ += 1;
        const float b1 = cfg_.beta1, b2 = cfg_.beta2;
        const float bc1 = 1.0f - std::pow(b1, static_cast<float>(step_));
        const float bc2 = 1.0f - std::pow(b2, static_cast<float>(step_));
        for (int64_t i = 0; i < len; ++i) {
          m[i] = b1 * m[i] + (1 - b1) * g[i];
          v[i] = b2 * v[i] + (1 - b2) * g[i] * g[i];
          w[i] -= cfg_.lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + cfg_.eps);
        }
        break;
      }
    }
  }

  int64_t size() const { return static_cast<int64_t>(w_.size()); }

  bool save(FILE* f) const {
    std::lock_guard<std::mutex> g(mu_);
    int64_t n = size();
    fwrite(&n, 8, 1, f);
    fwrite(&step_, 4, 1, f);
    fwrite(w_.data(), sizeof(float), w_.size(), f);
    fwrite(state_.data(), sizeof(float), state_.size(), f);
    return true;
  }

  bool load(FILE* f) {
    std::lock_guard<std::mutex> g(mu_);
    int64_t n = 0;
    if (fread(&n, 8, 1, f) != 1 || n != size()) return false;
    if (fread(&step_, 4, 1, f) != 1) return false;
    if (fread(w_.data(), sizeof(float), w_.size(), f) != w_.size()) return false;
    if (!state_.empty() &&
        fread(state_.data(), sizeof(float), state_.size(), f) != state_.size())
      return false;
    return true;
  }

  const TableConfig& config() const { return cfg_; }

 private:
  TableConfig cfg_;
  mutable std::mutex mu_;
  std::vector<float> w_;
  std::vector<float> state_;
  uint32_t step_ = 0;
};

// Graph table (reference ps/table/common_graph_table.cc): adjacency lists
// with edge weights, served to GNN samplers (the host side of
// graph_khop_sampler / graph_send_recv pipelines). Nodes shard across
// servers by node id (client side), and across internal buckets here.
class GraphTable {
 public:
  static constexpr int kShards = 16;

  void add_edges(const uint64_t* src, const uint64_t* dst,
                 const float* w, int64_t n) {
    // group by shard first: one lock per touched shard per batch, not
    // per edge (bulk loads are the GNN norm)
    std::vector<int64_t> order[kShards];
    for (int64_t i = 0; i < n; ++i)
      order[splitmix64(src[i]) % kShards].push_back(i);
    for (int b = 0; b < kShards; ++b) {
      if (order[b].empty()) continue;
      Shard& s = shards_[b];
      std::lock_guard<std::mutex> g(s.mu);
      for (int64_t i : order[b])
        s.adj[src[i]].emplace_back(dst[i], w ? w[i] : 1.0f);
    }
  }

  int64_t degree(uint64_t node) {
    Shard& s = shard(node);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.adj.find(node);
    return it == s.adj.end() ? 0 : static_cast<int64_t>(it->second.size());
  }

  // Sample up to k neighbors per node, weight-proportional without
  // replacement when deg > k (reference WeightedSampler); all neighbors
  // when deg <= k. Deterministic under `seed`.
  void sample(const uint64_t* nodes, int64_t n, int32_t k, uint64_t seed,
              std::vector<int32_t>* counts, std::vector<uint64_t>* out) {
    counts->resize(n);
    out->clear();
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard(nodes[i]);
      std::lock_guard<std::mutex> g(s.mu);
      auto it = s.adj.find(nodes[i]);
      if (it == s.adj.end()) {
        (*counts)[i] = 0;
        continue;
      }
      auto& nb = it->second;
      int32_t deg = static_cast<int32_t>(nb.size());
      if (deg <= k) {
        (*counts)[i] = deg;
        for (auto& p : nb) out->push_back(p.first);
        continue;
      }
      // weighted sampling without replacement (A-ES: keys u^(1/w), top-k)
      uint64_t h = splitmix64(seed ^ nodes[i]);
      std::vector<std::pair<float, uint64_t>> keyed;
      keyed.reserve(deg);
      for (auto& p : nb) {
        h = splitmix64(h);
        float u = unit_uniform(h);
        float wgt = p.second > 0 ? p.second : 1e-6f;
        keyed.emplace_back(std::pow(u, 1.0f / wgt), p.first);
      }
      std::partial_sort(keyed.begin(), keyed.begin() + k, keyed.end(),
                        [](auto& a, auto& b) { return a.first > b.first; });
      (*counts)[i] = k;
      for (int32_t j = 0; j < k; ++j) out->push_back(keyed[j].second);
    }
  }

  int64_t node_count() const {
    int64_t t = 0;
    for (const Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      t += static_cast<int64_t>(s.adj.size());
    }
    return t;
  }

  bool save(FILE* f) const {
    int64_t nodes = node_count();
    fwrite(&nodes, 8, 1, f);
    for (const Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      for (const auto& kv : s.adj) {
        fwrite(&kv.first, 8, 1, f);
        int64_t deg = static_cast<int64_t>(kv.second.size());
        fwrite(&deg, 8, 1, f);
        for (const auto& e : kv.second) {
          fwrite(&e.first, 8, 1, f);
          fwrite(&e.second, 4, 1, f);
        }
      }
    }
    return true;
  }

  bool load(FILE* f) {
    int64_t nodes = 0;
    if (fread(&nodes, 8, 1, f) != 1) return false;
    for (int64_t i = 0; i < nodes; ++i) {
      uint64_t node;
      int64_t deg;
      if (fread(&node, 8, 1, f) != 1 || fread(&deg, 8, 1, f) != 1 ||
          deg < 0)
        return false;
      Shard& s = shard(node);
      std::lock_guard<std::mutex> g(s.mu);
      auto& vec = s.adj[node];
      vec.clear();
      vec.reserve(deg);
      for (int64_t j = 0; j < deg; ++j) {
        uint64_t dst;
        float w;
        if (fread(&dst, 8, 1, f) != 1 || fread(&w, 4, 1, f) != 1)
          return false;
        vec.emplace_back(dst, w);
      }
    }
    return true;
  }

 private:
  struct Shard {
    mutable std::mutex mu;
    std::unordered_map<uint64_t,
                       std::vector<std::pair<uint64_t, float>>> adj;
  };
  Shard& shard(uint64_t key) { return shards_[splitmix64(key) % kShards]; }
  Shard shards_[kShards];
};


struct Barrier {
  int count = 0;
  int64_t generation = 0;
  std::condition_variable cv;
};

class Server {
 public:
  explicit Server(int port) {
    listen_fd_ = ptnet::listen_on(port);
    if (listen_fd_ >= 0) port_ = ptnet::bound_port(listen_fd_);
  }

  ~Server() { stop(); }

  bool ok() const { return listen_fd_ >= 0; }
  int port() const { return port_; }

  void start() {
    running_ = true;
    accept_thread_ = std::thread([this] { accept_loop(); });
  }

  void run() {
    running_ = true;
    accept_loop();
  }

  void stop() {
    if (!running_.exchange(false)) {
      if (listen_fd_ >= 0) { ::close(listen_fd_); listen_fd_ = -1; }
    } else if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    {
      std::lock_guard<std::mutex> g(barrier_mu_);
      for (auto& kv : barriers_) kv.second.cv.notify_all();
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    std::lock_guard<std::mutex> g(conn_mu_);
    // unblock connection threads parked in recv() so they can be joined
    for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
    for (auto& t : conn_threads_)
      if (t.joinable()) t.join();
    conn_threads_.clear();
    conn_fds_.clear();
  }

  void wait() {  // block until STOP command arrives
    std::unique_lock<std::mutex> lk(stopped_mu_);
    stopped_cv_.wait(lk, [this] { return stopped_flag_; });
  }

 private:
  void accept_loop() {
    while (running_) {
      int cfd = ::accept(listen_fd_, nullptr, nullptr);
      if (cfd < 0) break;
      int one = 1;
      ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(conn_mu_);
      conn_fds_.push_back(cfd);
      conn_threads_.emplace_back([this, cfd] { serve(cfd); });
    }
  }

  void serve(int fd) {
    std::vector<char> body;
    while (running_) {
      if (!ptnet::recv_frame(fd, &body)) break;
      if (body.empty()) break;
      Reader r(body.data(), body.size());
      uint8_t cmd = r.u8();
      int32_t tid = r.i32();
      Writer resp;
      {
        std::lock_guard<std::mutex> g(flight_mu_);
        in_flight_ += 1;
      }
      bool keep = handle(cmd, tid, &r, &resp);
      if (r.failed()) {  // malformed frame: report and drop the connection
        resp = Writer();
        err(&resp, "malformed frame");
        keep = false;
      }
      ptnet::send_frame(fd, resp);
      {
        std::lock_guard<std::mutex> g(flight_mu_);
        in_flight_ -= 1;
      }
      flight_cv_.notify_all();
      if (!keep) break;
    }
    ::close(fd);
  }

  bool handle(uint8_t cmd, int32_t tid, Reader* r, Writer* resp) {
    switch (cmd) {
      case CMD_PING:
        resp->u8(ST_OK);
        return true;
      case CMD_CREATE_TABLE: {
        TableConfig cfg;
        cfg.kind = r->u8();
        cfg.dim = r->i32();
        cfg.dense_size = r->i64();
        cfg.opt = r->u8();
        cfg.lr = r->f32();
        cfg.init_range = r->f32();
        cfg.seed = r->u64();
        if (r->failed()) return err(resp, "truncated frame");
        // well-formed but semantically invalid values must not crash/OOM
        // the server (dim drives a division in PULL_SPARSE's bound check;
        // dense_size drives an allocation)
        if (cfg.kind > 1 || cfg.opt > OPT_SUM || cfg.dim < 1 ||
            cfg.dim > 65536 || cfg.dense_size < 0 ||
            cfg.dense_size > (1LL << 33))
          return err(resp, "bad table config");
        std::lock_guard<std::mutex> g(tables_mu_);
        if (cfg.kind == 0) {
          if (!dense_.count(tid)) dense_[tid] = std::make_unique<DenseTable>(cfg);
        } else {
          if (!sparse_.count(tid)) sparse_[tid] = std::make_unique<SparseTable>(cfg);
        }
        resp->u8(ST_OK);
        return true;
      }
      case CMD_PULL_DENSE: {
        DenseTable* t = dense(tid);
        if (!t) return err(resp, "no such dense table");
        int64_t off = r->i64();
        int64_t len = r->i64();
        if (r->failed() || !t->range_ok(off, len) ||
            len > static_cast<int64_t>(ptnet::kMaxFrameLen) / 4 - 16)
          return err(resp, "bad dense range");
        resp->u8(ST_OK);
        resp->i64(len);
        size_t boff = resp->buf.size();
        resp->buf.resize(boff + len * sizeof(float));
        t->pull(reinterpret_cast<float*>(resp->buf.data() + boff), off, len);
        return true;
      }
      case CMD_PUSH_DENSE: {
        DenseTable* t = dense(tid);
        if (!t) return err(resp, "no such dense table");
        int64_t off = r->i64();
        int64_t len = r->i64();
        if (r->failed() || !t->range_ok(off, len))
          return err(resp, "bad dense range");
        const float* g =
            reinterpret_cast<const float*>(r->raw(len * sizeof(float)));
        if (!g && len > 0) return err(resp, "truncated frame");
        t->push(g, off, len);
        resp->u8(ST_OK);
        return true;
      }
      case CMD_SET_DENSE: {
        DenseTable* t = dense(tid);
        if (!t) return err(resp, "no such dense table");
        int64_t off = r->i64();
        int64_t len = r->i64();
        if (r->failed() || !t->range_ok(off, len))
          return err(resp, "bad dense range");
        const float* vals =
            reinterpret_cast<const float*>(r->raw(len * sizeof(float)));
        if (!vals && len > 0) return err(resp, "truncated frame");
        t->set(vals, off, len);
        resp->u8(ST_OK);
        return true;
      }
      case CMD_PULL_SPARSE: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        int64_t n = r->i64();
        // bound by BOTH request bytes and response bytes (n*dim*4)
        if (n < 0 || n > static_cast<int64_t>(ptnet::kMaxFrameLen) /
                             (8 + static_cast<int64_t>(t->config().dim) * 4))
          return err(resp, "bad key count");
        const uint64_t* keys =
            reinterpret_cast<const uint64_t*>(r->raw(n * sizeof(uint64_t)));
        if (!keys && n > 0) return err(resp, "truncated frame");
        resp->u8(ST_OK);
        resp->i64(n * t->config().dim);
        size_t off = resp->buf.size();
        resp->buf.resize(off + n * t->config().dim * sizeof(float));
        t->pull(keys, n, reinterpret_cast<float*>(resp->buf.data() + off));
        return true;
      }
      case CMD_PUSH_SPARSE: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        int64_t n = r->i64();
        if (n < 0 || n > static_cast<int64_t>(ptnet::kMaxFrameLen) / 8)
          return err(resp, "bad key count");
        const uint64_t* keys =
            reinterpret_cast<const uint64_t*>(r->raw(n * sizeof(uint64_t)));
        const float* grads = reinterpret_cast<const float*>(
            r->raw(n * t->config().dim * sizeof(float)));
        if (n > 0 && (!keys || !grads)) return err(resp, "truncated frame");
        t->push(keys, n, grads);
        resp->u8(ST_OK);
        return true;
      }
      case CMD_PUSH_SHOW_CLICK: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        int64_t n = r->i64();
        if (n < 0 || n > static_cast<int64_t>(ptnet::kMaxFrameLen) / 8)
          return err(resp, "bad key count");
        const uint64_t* keys =
            reinterpret_cast<const uint64_t*>(r->raw(n * sizeof(uint64_t)));
        const float* shows =
            reinterpret_cast<const float*>(r->raw(n * sizeof(float)));
        const float* clicks =
            reinterpret_cast<const float*>(r->raw(n * sizeof(float)));
        if (n > 0 && (!keys || !shows || !clicks))
          return err(resp, "truncated frame");
        t->push_show_click(keys, n, shows, clicks);
        resp->u8(ST_OK);
        return true;
      }
      case CMD_SHRINK: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        float threshold = r->f32();
        int32_t max_unseen = r->i32();
        if (r->failed()) return err(resp, "truncated frame");
        int64_t evicted = t->shrink(threshold, max_unseen);
        resp->u8(ST_OK);
        resp->i64(evicted);
        return true;
      }
      case CMD_PULL_META: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        int64_t n = r->i64();
        if (n < 0 || n > static_cast<int64_t>(ptnet::kMaxFrameLen) / 20)
          return err(resp, "bad key count");  // 8B key in + 12B meta out
        const uint64_t* keys =
            reinterpret_cast<const uint64_t*>(r->raw(n * sizeof(uint64_t)));
        if (!keys && n > 0) return err(resp, "truncated frame");
        std::vector<float> show(n), click(n);
        std::vector<int32_t> unseen(n);
        t->pull_meta(keys, n, show.data(), click.data(), unseen.data());
        resp->u8(ST_OK);
        resp->i64(n);
        resp->bytes(show.data(), n * sizeof(float));
        resp->bytes(click.data(), n * sizeof(float));
        resp->bytes(unseen.data(), n * sizeof(int32_t));
        return true;
      }
      case CMD_SET_SPILL: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        std::string path = r->str();
        if (r->failed()) return err(resp, "truncated frame");
        if (!t->set_spill(path)) return err(resp, "cannot open spill file");
        resp->u8(ST_OK);
        return true;
      }
      case CMD_SPILL_COLD: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        int32_t max_unseen = r->i32();
        if (r->failed()) return err(resp, "truncated frame");
        int64_t n = t->spill_cold(max_unseen);
        if (n < 0) return err(resp, "spill not enabled (CMD_SET_SPILL first)");
        resp->u8(ST_OK);
        resp->i64(n);
        return true;
      }
      case CMD_SPILLED_SIZE: {
        SparseTable* t = sparse(tid);
        if (!t) return err(resp, "no such sparse table");
        resp->u8(ST_OK);
        resp->i64(t->spilled_size());
        return true;
      }
      case CMD_GRAPH_ADD_EDGES: {
        GraphTable* t = graph_or_create(tid);
        int64_t n = r->i64();
        uint8_t has_w = r->u8();
        if (n < 0 || n > static_cast<int64_t>(ptnet::kMaxFrameLen) / 20)
          return err(resp, "bad edge count");
        const uint64_t* src =
            reinterpret_cast<const uint64_t*>(r->raw(n * 8));
        const uint64_t* dst =
            reinterpret_cast<const uint64_t*>(r->raw(n * 8));
        const float* w = nullptr;
        if (has_w)
          w = reinterpret_cast<const float*>(r->raw(n * 4));
        if (n > 0 && (!src || !dst || (has_w && !w)))
          return err(resp, "truncated frame");
        t->add_edges(src, dst, w, n);
        resp->u8(ST_OK);
        return true;
      }
      case CMD_GRAPH_SAMPLE: {
        GraphTable* t = graph(tid);
        if (!t) return err(resp, "no such graph table");
        int64_t n = r->i64();
        int32_t k = r->i32();
        uint64_t seed = r->u64();
        if (n < 0 || k < 0 ||
            n > static_cast<int64_t>(ptnet::kMaxFrameLen) /
                    (8 + 4 + 8 * std::max(k, 1)))
          return err(resp, "bad sample request");
        const uint64_t* nodes =
            reinterpret_cast<const uint64_t*>(r->raw(n * 8));
        if (n > 0 && !nodes) return err(resp, "truncated frame");
        std::vector<int32_t> counts;
        std::vector<uint64_t> out;
        t->sample(nodes, n, k, seed, &counts, &out);
        resp->u8(ST_OK);
        resp->i64(n);
        resp->i64(static_cast<int64_t>(out.size()));
        resp->bytes(counts.data(), counts.size() * 4);
        resp->bytes(out.data(), out.size() * 8);
        return true;
      }
      case CMD_GRAPH_DEGREE: {
        GraphTable* t = graph(tid);
        if (!t) return err(resp, "no such graph table");
        int64_t n = r->i64();
        if (n < 0 || n > static_cast<int64_t>(ptnet::kMaxFrameLen) / 16)
          return err(resp, "bad node count");
        const uint64_t* nodes =
            reinterpret_cast<const uint64_t*>(r->raw(n * 8));
        if (n > 0 && !nodes) return err(resp, "truncated frame");
        std::vector<int64_t> degs(n);
        for (int64_t i = 0; i < n; ++i) degs[i] = t->degree(nodes[i]);
        resp->u8(ST_OK);
        resp->i64(n);
        resp->bytes(degs.data(), n * 8);
        return true;
      }
      case CMD_TABLE_SIZE: {
        std::lock_guard<std::mutex> g(tables_mu_);
        auto it = sparse_.find(tid);
        int64_t n = -1;
        if (it != sparse_.end()) {
          n = it->second->size();
        } else {
          auto gt = graph_.find(tid);
          if (gt != graph_.end()) n = gt->second->node_count();
        }
        resp->u8(ST_OK);
        resp->i64(n);
        return true;
      }
      case CMD_SAVE: {
        std::string dir = r->str();
        std::lock_guard<std::mutex> g(tables_mu_);
        for (auto& kv : dense_)
          if (!save_one(dir, kv.first, /*sparse=*/false))
            return err(resp, "save failed");
        for (auto& kv : sparse_)
          if (!save_one(dir, kv.first, /*sparse=*/true))
            return err(resp, "save failed");
        for (auto& kv : graph_) {
          FILE* f = fopen((dir + "/graph_" +
                           std::to_string(kv.first) + ".bin").c_str(), "wb");
          if (!f) return err(resp, "save failed");
          bool ok = kv.second->save(f);
          fclose(f);
          if (!ok) return err(resp, "save failed");
        }
        resp->u8(ST_OK);
        return true;
      }
      case CMD_LOAD: {
        std::string dir = r->str();
        std::lock_guard<std::mutex> g(tables_mu_);
        for (auto& kv : dense_)
          if (!load_one(dir, kv.first, /*sparse=*/false))
            return err(resp, "load failed");
        for (auto& kv : sparse_)
          if (!load_one(dir, kv.first, /*sparse=*/true))
            return err(resp, "load failed");
        for (auto& kv : graph_) {
          FILE* f = fopen((dir + "/graph_" +
                           std::to_string(kv.first) + ".bin").c_str(), "rb");
          if (!f) return err(resp, "load failed");
          bool ok = kv.second->load(f);
          fclose(f);
          if (!ok) return err(resp, "load failed");
        }
        resp->u8(ST_OK);
        return true;
      }
      case CMD_BARRIER: {
        std::string name = r->str();
        int32_t world = r->i32();
        std::unique_lock<std::mutex> lk(barrier_mu_);
        Barrier& b = barriers_[name];
        int64_t my_gen = b.generation;
        bool released = true;
        if (++b.count >= world) {
          b.count = 0;
          b.generation += 1;
          b.cv.notify_all();
        } else {
          // while PARKED this request must not block a STOP drain (a dead
          // peer would otherwise force the drain's full timeout) — it is
          // re-counted the moment it wakes, so a RELEASED barrier response
          // still holds STOP back until it is sent
          mark_parked(+1);
          b.cv.wait(lk, [&] { return !running_ || b.generation != my_gen; });
          mark_parked(-1);
          // success iff the barrier actually tripped; a concurrent STOP may
          // have flipped running_ AFTER releasing us, which is still success
          released = b.generation != my_gen;
        }
        resp->u8(released ? ST_OK : ST_ERR);
        return true;
      }
      case CMD_STOP: {
        // a barrier release may still be mid-send on a peer connection —
        // wait until every OTHER active request has written its response
        // before tearing the server down. Parked barrier waiters and other
        // concurrent STOPs are excluded from the count (a dead peer's
        // barrier, or a redundant STOP, must not stall shutdown).
        {
          std::unique_lock<std::mutex> lk(flight_mu_);
          stops_pending_ += 1;
          flight_cv_.wait_for(lk, std::chrono::seconds(5), [this] {
            return in_flight_ - parked_ - stops_pending_ <= 0;
          });
          stops_pending_ -= 1;
        }
        resp->u8(ST_OK);
        running_ = false;
        ::shutdown(listen_fd_, SHUT_RDWR);
        {
          std::lock_guard<std::mutex> g(stopped_mu_);
          stopped_flag_ = true;
        }
        stopped_cv_.notify_all();
        return false;
      }
      default:
        return err(resp, "bad command");
    }
  }

  bool err(Writer* resp, const char* msg) {
    resp->buf.clear();
    resp->u8(ST_ERR);
    resp->str(msg);
    return true;
  }

  DenseTable* dense(int32_t tid) {
    std::lock_guard<std::mutex> g(tables_mu_);
    auto it = dense_.find(tid);
    return it == dense_.end() ? nullptr : it->second.get();
  }

  SparseTable* sparse(int32_t tid) {
    std::lock_guard<std::mutex> g(tables_mu_);
    auto it = sparse_.find(tid);
    return it == sparse_.end() ? nullptr : it->second.get();
  }

  // Lookup only: read-side graph commands (sample/degree) must report
  // "no such table" for a typo'd id instead of silently answering from a
  // phantom empty table (ADVICE r2).
  GraphTable* graph(int32_t tid) {
    std::lock_guard<std::mutex> g(tables_mu_);
    auto it = graph_.find(tid);
    return it == graph_.end() ? nullptr : it->second.get();
  }

  GraphTable* graph_or_create(int32_t tid) {
    std::lock_guard<std::mutex> g(tables_mu_);
    auto it = graph_.find(tid);
    if (it == graph_.end())
      it = graph_.emplace(tid, std::make_unique<GraphTable>()).first;
    return it->second.get();
  }

  std::string table_path(const std::string& dir, int32_t tid, bool sp) const {
    return dir + "/" + (sp ? "sparse_" : "dense_") + std::to_string(tid) + ".bin";
  }

  bool save_one(const std::string& dir, int32_t tid, bool sp) {
    FILE* f = fopen(table_path(dir, tid, sp).c_str(), "wb");
    if (!f) return false;
    bool ok = sp ? sparse_[tid]->save(f) : dense_[tid]->save(f);
    fclose(f);
    return ok;
  }

  bool load_one(const std::string& dir, int32_t tid, bool sp) {
    FILE* f = fopen(table_path(dir, tid, sp).c_str(), "rb");
    if (!f) return false;
    bool ok = sp ? sparse_[tid]->load(f) : dense_[tid]->load(f);
    fclose(f);
    return ok;
  }

  int listen_fd_ = -1;
  int port_ = -1;
  std::atomic<bool> running_{false};
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::vector<std::thread> conn_threads_;
  std::vector<int> conn_fds_;

  std::mutex tables_mu_;
  std::map<int32_t, std::unique_ptr<DenseTable>> dense_;
  std::map<int32_t, std::unique_ptr<SparseTable>> sparse_;
  std::map<int32_t, std::unique_ptr<GraphTable>> graph_;

  std::mutex barrier_mu_;
  std::map<std::string, Barrier> barriers_;

  std::mutex stopped_mu_;
  std::condition_variable stopped_cv_;
  bool stopped_flag_ = false;

  void mark_parked(int delta) {
    {
      std::lock_guard<std::mutex> g(flight_mu_);
      parked_ += delta;
    }
    flight_cv_.notify_all();
  }

  std::mutex flight_mu_;
  std::condition_variable flight_cv_;
  int in_flight_ = 0;
  int parked_ = 0;        // barrier waiters blocked on their cv
  int stops_pending_ = 0; // concurrent CMD_STOP handlers
};

// ------------------------------ client -------------------------------------

class Client {
 public:
  Client(const std::string& host, int port, int timeout_ms) {
    fd_ = ptnet::connect_to(host, port, timeout_ms);
  }
  ~Client() {
    if (fd_ >= 0) ::close(fd_);
  }
  bool ok() const { return fd_ >= 0; }

  // Returns ST_OK/ST_ERR; resp body (after status byte) in `out`.
  int request(const Writer& w, std::vector<char>* out) {
    std::lock_guard<std::mutex> g(mu_);
    if (fd_ < 0) return -1;
    if (!ptnet::send_frame(fd_, w)) return -1;
    std::vector<char> body;
    if (!ptnet::recv_frame(fd_, &body) || body.empty()) return -1;
    uint8_t st = static_cast<uint8_t>(body[0]);
    out->assign(body.begin() + 1, body.end());
    return st;
  }

 private:
  int fd_ = -1;
  std::mutex mu_;
};

}  // namespace ps

// ----------------------------- C API ---------------------------------------
// ctypes-facing flat API (the rebuild's pybind layer, reference
// paddle/fluid/pybind/ — we use ctypes over extern "C" instead of pybind11).

namespace {
std::mutex g_mu;
std::vector<std::unique_ptr<ps::Server>> g_servers;
std::vector<std::unique_ptr<ps::Client>> g_clients;

ps::Server* server(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int>(g_servers.size())) return nullptr;
  return g_servers[h].get();
}

ps::Client* client(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int>(g_clients.size())) return nullptr;
  return g_clients[h].get();
}
}  // namespace

extern "C" {

int ps_server_create(int port) {
  auto s = std::make_unique<ps::Server>(port);
  if (!s->ok()) return -1;
  std::lock_guard<std::mutex> g(g_mu);
  g_servers.push_back(std::move(s));
  return static_cast<int>(g_servers.size()) - 1;
}

int ps_server_port(int h) {
  ps::Server* s = server(h);
  return s ? s->port() : -1;
}

int ps_server_start(int h) {
  ps::Server* s = server(h);
  if (!s) return -1;
  s->start();
  return 0;
}

int ps_server_wait(int h) {
  ps::Server* s = server(h);
  if (!s) return -1;
  s->wait();
  return 0;
}

int ps_server_stop(int h) {
  ps::Server* s = server(h);
  if (!s) return -1;
  s->stop();
  return 0;
}

int ps_connect(const char* host, int port, int timeout_ms) {
  auto c = std::make_unique<ps::Client>(host, port, timeout_ms);
  if (!c->ok()) return -1;
  std::lock_guard<std::mutex> g(g_mu);
  g_clients.push_back(std::move(c));
  return static_cast<int>(g_clients.size()) - 1;
}

static int simple_req(int h, ps::Writer& w) {
  ps::Client* c = client(h);
  if (!c) return -1;
  std::vector<char> out;
  int st = c->request(w, &out);
  return st == ps::ST_OK ? 0 : -1;
}

int ps_ping(int h) {
  ps::Writer w;
  w.u8(ps::CMD_PING);
  w.i32(0);
  return simple_req(h, w);
}

int ps_create_table(int h, int table_id, int kind, int dim, int64_t dense_size,
                    int opt, float lr, float init_range, uint64_t seed) {
  ps::Writer w;
  w.u8(ps::CMD_CREATE_TABLE);
  w.i32(table_id);
  w.u8(static_cast<uint8_t>(kind));
  w.i32(dim);
  w.i64(dense_size);
  w.u8(static_cast<uint8_t>(opt));
  w.f32(lr);
  w.f32(init_range);
  w.u64(seed);
  return simple_req(h, w);
}

int ps_pull_dense(int h, int table_id, float* out, int64_t off, int64_t len) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_PULL_DENSE);
  w.i32(table_id);
  w.i64(off);
  w.i64(len);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  int64_t got = r.i64();
  if (got != len) return -1;
  const char* src = r.raw(len * sizeof(float));
  if (!src) return -1;
  std::memcpy(out, src, len * sizeof(float));
  return 0;
}

int ps_push_dense(int h, int table_id, const float* grad, int64_t off,
                  int64_t len) {
  ps::Writer w;
  w.u8(ps::CMD_PUSH_DENSE);
  w.i32(table_id);
  w.i64(off);
  w.i64(len);
  w.bytes(grad, len * sizeof(float));
  return simple_req(h, w);
}

int ps_set_dense(int h, int table_id, const float* vals, int64_t off,
                 int64_t len) {
  ps::Writer w;
  w.u8(ps::CMD_SET_DENSE);
  w.i32(table_id);
  w.i64(off);
  w.i64(len);
  w.bytes(vals, len * sizeof(float));
  return simple_req(h, w);
}

int ps_pull_sparse(int h, int table_id, const uint64_t* keys, int64_t n,
                   float* out, int64_t out_len) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_PULL_SPARSE);
  w.i32(table_id);
  w.i64(n);
  w.bytes(keys, n * sizeof(uint64_t));
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  int64_t got = r.i64();
  if (got != out_len) return -1;
  const char* src = r.raw(got * sizeof(float));
  if (!src) return -1;
  std::memcpy(out, src, got * sizeof(float));
  return 0;
}

int ps_push_sparse(int h, int table_id, const uint64_t* keys, int64_t n,
                   const float* grads, int64_t grad_len) {
  ps::Writer w;
  w.u8(ps::CMD_PUSH_SPARSE);
  w.i32(table_id);
  w.i64(n);
  w.bytes(keys, n * sizeof(uint64_t));
  w.bytes(grads, grad_len * sizeof(float));
  return simple_req(h, w);
}

int64_t ps_table_size(int h, int table_id) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_TABLE_SIZE);
  w.i32(table_id);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  return r.i64();
}

int ps_save(int h, const char* dir) {
  ps::Writer w;
  w.u8(ps::CMD_SAVE);
  w.i32(-1);
  w.str(dir);
  return simple_req(h, w);
}

int ps_load(int h, const char* dir) {
  ps::Writer w;
  w.u8(ps::CMD_LOAD);
  w.i32(-1);
  w.str(dir);
  return simple_req(h, w);
}

int ps_barrier(int h, const char* name, int world) {
  ps::Writer w;
  w.u8(ps::CMD_BARRIER);
  w.i32(-1);
  w.str(name);
  w.i32(world);
  return simple_req(h, w);
}

int ps_stop_server(int h) {
  ps::Writer w;
  w.u8(ps::CMD_STOP);
  w.i32(-1);
  return simple_req(h, w);
}

int ps_push_show_click(int h, int table_id, const uint64_t* keys, int64_t n,
                       const float* shows, const float* clicks) {
  ps::Writer w;
  w.u8(ps::CMD_PUSH_SHOW_CLICK);
  w.i32(table_id);
  w.i64(n);
  w.bytes(keys, n * sizeof(uint64_t));
  w.bytes(shows, n * sizeof(float));
  w.bytes(clicks, n * sizeof(float));
  return simple_req(h, w);
}

int64_t ps_shrink(int h, int table_id, float threshold, int max_unseen_days) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_SHRINK);
  w.i32(table_id);
  w.f32(threshold);
  w.i32(max_unseen_days);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  return r.i64();
}

int ps_graph_add_edges(int h, int table_id, const uint64_t* src,
                       const uint64_t* dst, const float* w, int64_t n) {
  ps::Writer wr;
  wr.u8(ps::CMD_GRAPH_ADD_EDGES);
  wr.i32(table_id);
  wr.i64(n);
  wr.u8(w ? 1 : 0);
  wr.bytes(src, n * 8);
  wr.bytes(dst, n * 8);
  if (w) wr.bytes(w, n * 4);
  return simple_req(h, wr);
}

// out must hold n*k u64; counts must hold n i32. Returns total sampled or -1.
int64_t ps_graph_sample(int h, int table_id, const uint64_t* nodes,
                        int64_t n, int k, uint64_t seed, int32_t* counts,
                        uint64_t* out) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_GRAPH_SAMPLE);
  w.i32(table_id);
  w.i64(n);
  w.i32(k);
  w.u64(seed);
  w.bytes(nodes, n * 8);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  int64_t got_n = r.i64();
  int64_t total = r.i64();
  if (got_n != n || total < 0 || total > n * static_cast<int64_t>(k))
    return -1;
  const char* pc = r.raw(n * 4);
  const char* po = r.raw(total * 8);
  if (!pc || (total > 0 && !po)) return -1;
  std::memcpy(counts, pc, n * 4);
  if (total > 0) std::memcpy(out, po, total * 8);
  return total;
}

int ps_graph_degree(int h, int table_id, const uint64_t* nodes, int64_t n,
                    int64_t* out) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_GRAPH_DEGREE);
  w.i32(table_id);
  w.i64(n);
  w.bytes(nodes, n * 8);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  if (r.i64() != n) return -1;
  const char* p = r.raw(n * 8);
  if (!p && n > 0) return -1;
  std::memcpy(out, p, n * 8);
  return 0;
}

int ps_set_spill(int h, int table_id, const char* path) {
  ps::Writer w;
  w.u8(ps::CMD_SET_SPILL);
  w.i32(table_id);
  w.str(path);
  return simple_req(h, w);
}

int64_t ps_spill_cold(int h, int table_id, int max_unseen_days) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_SPILL_COLD);
  w.i32(table_id);
  w.i32(max_unseen_days);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  return r.i64();
}

int64_t ps_spilled_size(int h, int table_id) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_SPILLED_SIZE);
  w.i32(table_id);
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  return r.i64();
}

int ps_pull_meta(int h, int table_id, const uint64_t* keys, int64_t n,
                 float* show, float* click, int32_t* unseen) {
  ps::Client* c = client(h);
  if (!c) return -1;
  ps::Writer w;
  w.u8(ps::CMD_PULL_META);
  w.i32(table_id);
  w.i64(n);
  w.bytes(keys, n * sizeof(uint64_t));
  std::vector<char> body;
  if (c->request(w, &body) != ps::ST_OK) return -1;
  ps::Reader r(body.data(), body.size());
  int64_t got = r.i64();
  if (got != n) return -1;
  const char* ps_ = r.raw(n * sizeof(float));
  const char* pc = r.raw(n * sizeof(float));
  const char* pu = r.raw(n * sizeof(int32_t));
  if (!ps_ || !pc || !pu) return -1;
  std::memcpy(show, ps_, n * sizeof(float));
  std::memcpy(click, pc, n * sizeof(float));
  std::memcpy(unseen, pu, n * sizeof(int32_t));
  return 0;
}

}  // extern "C"
