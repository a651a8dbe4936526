// Native host KV store — the LMDB-equivalent persistence engine.
//
// C++ replacement for the reference's storage substrate (heed/LMDB); a
// copy of hannoy_tpu/store/native/kvstore.cpp. Same durable format as the Python backend in
// ../env.py (append-only log of committed batches, magic "HNYT"), so the
// two backends open each other's files; this engine adds:
//
//   * MVCC snapshots: commits publish an immutable generation
//     (shared_ptr-swapped); read transactions pin a generation and never
//     block — LMDB's readers-don't-block-writers contract
//     (reference README.md:13).
//   * Crash consistency: a batch is visible only after fsync; torn tails
//     are truncated on open (nothing persists until commit).
//   * Sorted-key tables per named database: 8-byte big-endian keys are
//     stored as host u64 (order-preserving), so point gets are
//     binary searches and prefix scans are range scans
//     (reference src/key.rs prefix iteration).
//   * Bulk item staging: one call decodes an index's vector rows into a
//     caller-provided contiguous buffer — the hot path when loading a
//     graph into device memory (replaces the reference's madvise prefetch walk,
//     src/reader.rs:446-543).
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'H', 'N', 'Y', 'T'};
constexpr uint8_t kLogVersion = 1;
constexpr uint8_t kOpDel = 0;
constexpr uint8_t kOpPut = 1;

inline uint64_t key_to_u64(const uint8_t* k) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | k[i];
  return v;
}

inline void u64_to_key(uint64_t v, uint8_t* out) {
  for (int i = 7; i >= 0; i--) {
    out[i] = v & 0xff;
    v >>= 8;
  }
}

// One named database inside a generation: sorted (key, value) rows.
struct Table {
  std::vector<uint64_t> keys;           // sorted
  std::vector<std::string> values;      // parallel to keys
  int64_t find(uint64_t key) const {
    auto it = std::lower_bound(keys.begin(), keys.end(), key);
    if (it == keys.end() || *it != key) return -1;
    return it - keys.begin();
  }
};

struct Generation {
  std::map<std::string, Table> tables;
  uint64_t gen_id = 0;
};

using GenPtr = std::shared_ptr<const Generation>;

struct Overlay {
  // name -> (key -> value or nullopt-as-deleted)
  std::map<std::string, std::map<uint64_t, std::pair<bool, std::string>>> tables;
  uint64_t bytes = 0;
};

struct Env {
  std::string log_path;
  std::string snap_path;
  FILE* log = nullptr;
  int lock_fd = -1;  // sidecar hannoy.lock, held for the env's lifetime
  uint64_t map_size = 0;
  std::atomic<uint64_t> live_bytes{0};
  std::atomic<uint64_t> snap_covered{0};  // log bytes covered by hannoy.snap
  GenPtr gen;
  std::mutex write_mu;   // single writer
  std::mutex swap_mu;    // generation swap
  std::string error;
  // the last commit's batch bytes and the nanoseconds of its steps:
  // serialize, log (write + flush + fsync), publish (copy, merge, swap)
  std::mutex stats_mu;
  uint64_t last_commit[4] = {0, 0, 0, 0};
};

inline uint64_t ns_between(std::chrono::steady_clock::time_point a,
                           std::chrono::steady_clock::time_point b) {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(b - a).count();
}

struct Txn {
  Env* env;
  GenPtr gen;      // pinned snapshot
  Overlay* overlay;  // null for read txns
};

// ---------------------------------------------------------------------------
// Log replay / append (format identical to env.py) + snapshot sidecar
// ---------------------------------------------------------------------------

using OvTable = std::map<uint64_t, std::pair<bool, std::string>>;

// Merge a (key → put/tombstone) overlay into a sorted table, adjusting the
// live-byte counter. Shared by commit and log replay.
void merge_into(Table& table, const OvTable& ov, uint64_t& live) {
  std::vector<uint64_t> keys;
  std::vector<std::string> values;
  keys.reserve(table.keys.size() + ov.size());
  values.reserve(keys.capacity());
  size_t i = 0;
  auto it = ov.begin();
  while (i < table.keys.size() || it != ov.end()) {
    bool take_old;
    if (i >= table.keys.size()) take_old = false;
    else if (it == ov.end()) take_old = true;
    else take_old = table.keys[i] < it->first;
    if (take_old) {
      keys.push_back(table.keys[i]);
      values.push_back(std::move(table.values[i]));
      i++;
    } else {
      bool replace = i < table.keys.size() && table.keys[i] == it->first;
      if (replace) {
        live -= 24 + table.values[i].size();
        i++;
      }
      if (it->second.first) {
        live += 24 + it->second.second.size();
        keys.push_back(it->first);
        values.push_back(it->second.second);
      }
      ++it;
    }
  }
  table.keys = std::move(keys);
  table.values = std::move(values);
}

// Parse committed batches from `data` (log bytes starting at absolute
// offset `base`) into per-table overlays; returns the absolute offset of
// the last complete batch.
uint64_t parse_batches(const std::vector<uint8_t>& data, uint64_t base,
                       std::map<std::string, OvTable>& out) {
  size_t pos = 0, valid_end = 0;
  while (pos + 9 <= data.size()) {
    if (memcmp(&data[pos], kMagic, 4) != 0) break;
    uint8_t version = data[pos + 4];
    uint32_t plen = (data[pos + 5] << 24) | (data[pos + 6] << 16) |
                    (data[pos + 7] << 8) | data[pos + 8];
    if (version != kLogVersion || pos + 9 + plen > data.size()) break;
    size_t p = pos + 9, end = pos + 9 + plen;
    while (p < end) {
      uint8_t op = data[p];
      uint16_t nlen = (data[p + 1] << 8) | data[p + 2];
      p += 3;
      std::string name((const char*)&data[p], nlen);
      p += nlen;
      auto& table = out[name];
      if (op == kOpPut) {
        uint16_t klen = (data[p] << 8) | data[p + 1];
        uint32_t vlen = (data[p + 2] << 24) | (data[p + 3] << 16) |
                        (data[p + 4] << 8) | data[p + 5];
        p += 6;
        uint64_t key = key_to_u64(&data[p]);
        p += klen;
        table[key] = {true, std::string((const char*)&data[p], vlen)};
        p += vlen;
      } else {
        uint16_t klen = (data[p] << 8) | data[p + 1];
        p += 2;
        uint64_t key = key_to_u64(&data[p]);
        p += klen;
        table[key] = {false, std::string()};
      }
    }
    valid_end = end;
    pos = end;
  }
  return base + valid_end;
}

// --- snapshot sidecar ("hannoy.snap") --------------------------------------
// A native-only reopen cache: the full sorted table set as flat arrays, so
// opening a big store is a sequential read of the snapshot plus a replay of
// only the log *suffix* written after it — the role LMDB's B-tree pages
// play for the reference (no full-log replay on open). Validity is probed
// against the append-only log prefix it covers (head bytes + FNV-1a of the
// last 64 KiB); compaction rewrites the prefix and therefore the snapshot.
// Host-endian: this file never moves between machines (delete to rebuild).

constexpr char kSnapMagic[4] = {'H', 'N', 'Y', 'S'};
constexpr uint8_t kSnapVersion = 1;
constexpr size_t kSnapProbeTail = 65536;

uint64_t fnv1a(const uint8_t* p, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// Reads head/tail probe bytes of the first `covered` bytes of the log.
bool log_probes(const std::string& log_path, uint64_t covered, uint8_t head[16],
                uint32_t* head_len, uint64_t* tail_hash) {
  FILE* f = fopen(log_path.c_str(), "rb");
  if (!f) return false;
  *head_len = (uint32_t)std::min<uint64_t>(16, covered);
  if (*head_len && fread(head, 1, *head_len, f) != *head_len) {
    fclose(f);
    return false;
  }
  size_t tail_n = (size_t)std::min<uint64_t>(kSnapProbeTail, covered);
  std::vector<uint8_t> tail(tail_n);
  if (tail_n) {
    if (fseek(f, (long)(covered - tail_n), SEEK_SET) != 0 ||
        fread(tail.data(), 1, tail_n, f) != tail_n) {
      fclose(f);
      return false;
    }
  }
  fclose(f);
  *tail_hash = fnv1a(tail.data(), tail_n);
  return true;
}

template <typename T>
bool fread_vec(FILE* f, T* out, size_t n) {
  return n == 0 || fread(out, sizeof(T), n, f) == n;
}

// Attempts to seed `gen`/`live` from hannoy.snap. Returns covered log
// bytes on success, 0 otherwise (caller replays the whole log).
uint64_t try_load_snapshot(Env* env, Generation* gen, uint64_t* live,
                           uint64_t log_size) {
  FILE* f = fopen(env->snap_path.c_str(), "rb");
  if (!f) return 0;
  char magic[4];
  uint8_t ver = 0;
  uint64_t covered = 0, tail_hash = 0;
  uint32_t head_len = 0, n_tables = 0;
  uint8_t head[16];
  bool ok = fread(magic, 1, 4, f) == 4 && memcmp(magic, kSnapMagic, 4) == 0 &&
            fread(&ver, 1, 1, f) == 1 && ver == kSnapVersion &&
            fread_vec(f, &covered, 1) && fread_vec(f, &tail_hash, 1) &&
            fread_vec(f, &head_len, 1) && head_len <= 16 &&
            fread(head, 1, 16, f) == 16 && fread_vec(f, &n_tables, 1);
  if (ok && covered <= log_size) {
    uint8_t cur_head[16];
    uint32_t cur_head_len = 0;
    uint64_t cur_tail = 0;
    ok = log_probes(env->log_path, covered, cur_head, &cur_head_len, &cur_tail) &&
         cur_head_len == head_len && memcmp(cur_head, head, head_len) == 0 &&
         cur_tail == tail_hash;
  } else {
    ok = false;
  }
  if (!ok) {
    fclose(f);
    return 0;
  }
  for (uint32_t t = 0; ok && t < n_tables; t++) {
    uint16_t nlen = 0;
    uint64_t nrows = 0, blob_bytes = 0;
    ok = fread_vec(f, &nlen, 1);
    std::string name(nlen, '\0');
    ok = ok && fread(name.data(), 1, nlen, f) == nlen && fread_vec(f, &nrows, 1) &&
         fread_vec(f, &blob_bytes, 1);
    if (!ok) break;
    Table table;
    table.keys.resize(nrows);
    std::vector<uint32_t> lens(nrows);
    std::vector<char> blob(blob_bytes);
    ok = fread_vec(f, table.keys.data(), nrows) && fread_vec(f, lens.data(), nrows) &&
         fread_vec(f, blob.data(), blob_bytes);
    if (!ok) break;
    table.values.reserve(nrows);
    size_t off = 0;
    for (uint64_t i = 0; i < nrows; i++) {
      if (off + lens[i] > blob_bytes) {
        ok = false;
        break;
      }
      table.values.emplace_back(blob.data() + off, lens[i]);
      *live += 24 + lens[i];
      off += lens[i];
    }
    if (ok) gen->tables.emplace(std::move(name), std::move(table));
  }
  fclose(f);
  if (!ok) {
    gen->tables.clear();
    *live = 0;
    return 0;
  }
  return covered;
}

// Writes hannoy.snap for the current generation; caller holds write_mu.
int write_snapshot_locked(Env* env) {
  GenPtr gen;
  {
    std::lock_guard<std::mutex> s(env->swap_mu);
    gen = env->gen;
  }
  if (env->log) fflush(env->log);
  struct stat st;
  uint64_t covered = (stat(env->log_path.c_str(), &st) == 0) ? (uint64_t)st.st_size : 0;
  uint8_t head[16] = {0};
  uint32_t head_len = 0;
  uint64_t tail_hash = fnv1a(nullptr, 0);
  if (covered && !log_probes(env->log_path, covered, head, &head_len, &tail_hash))
    return -2;
  std::string tmp = env->snap_path + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -2;
  uint32_t n_tables = (uint32_t)gen->tables.size();
  bool ok = fwrite(kSnapMagic, 1, 4, f) == 4 && fwrite(&kSnapVersion, 1, 1, f) == 1 &&
            fwrite(&covered, 8, 1, f) == 1 && fwrite(&tail_hash, 8, 1, f) == 1 &&
            fwrite(&head_len, 4, 1, f) == 1 && fwrite(head, 1, 16, f) == 16 &&
            fwrite(&n_tables, 4, 1, f) == 1;
  for (const auto& [name, table] : gen->tables) {
    if (!ok) break;
    uint16_t nlen = (uint16_t)name.size();
    uint64_t nrows = table.keys.size(), blob_bytes = 0;
    std::vector<uint32_t> lens(nrows);
    for (uint64_t i = 0; i < nrows; i++) {
      lens[i] = (uint32_t)table.values[i].size();
      blob_bytes += lens[i];
    }
    ok = fwrite(&nlen, 2, 1, f) == 1 && fwrite(name.data(), 1, nlen, f) == nlen &&
         fwrite(&nrows, 8, 1, f) == 1 && fwrite(&blob_bytes, 8, 1, f) == 1 &&
         (nrows == 0 || (fwrite(table.keys.data(), 8, nrows, f) == nrows &&
                         fwrite(lens.data(), 4, nrows, f) == nrows));
    for (uint64_t i = 0; ok && i < nrows; i++)
      ok = table.values[i].empty() ||
           fwrite(table.values[i].data(), 1, lens[i], f) == lens[i];
  }
  ok = ok && fflush(f) == 0 && fsync(fileno(f)) == 0;
  fclose(f);
  if (!ok || rename(tmp.c_str(), env->snap_path.c_str()) != 0) {
    unlink(tmp.c_str());
    return -2;
  }
  env->snap_covered = covered;
  return 0;
}

bool replay_log(Env* env) {
  auto gen = std::make_shared<Generation>();
  uint64_t live = 0;
  struct stat st;
  if (stat(env->log_path.c_str(), &st) != 0) {
    env->gen = gen;
    return true;  // fresh store
  }
  uint64_t size = (uint64_t)st.st_size;
  uint64_t start = try_load_snapshot(env, gen.get(), &live, size);
  env->snap_covered = start;

  FILE* f = fopen(env->log_path.c_str(), "rb");
  if (!f) {
    env->error = "cannot read log";
    return false;
  }
  std::vector<uint8_t> data(size - start);
  bool read_ok = fseek(f, (long)start, SEEK_SET) == 0 &&
                 (data.empty() || fread(data.data(), 1, data.size(), f) == data.size());
  fclose(f);
  if (!read_ok) {
    env->error = "short read on log";
    return false;
  }

  std::map<std::string, OvTable> suffix;
  uint64_t valid_end = parse_batches(data, start, suffix);
  if (valid_end < size) {
    // torn tail from a crash — truncate so future appends start clean
    if (truncate(env->log_path.c_str(), valid_end) != 0) {
      env->error = "failed to truncate torn log tail";
      return false;
    }
  }
  for (auto& [name, ov] : suffix) merge_into(gen->tables[name], ov, live);
  env->live_bytes = live;
  env->gen = gen;
  return true;
}

void append_u16(std::string& out, uint16_t v) {
  out.push_back((char)(v >> 8));
  out.push_back((char)(v & 0xff));
}
void append_u32(std::string& out, uint32_t v) {
  out.push_back((char)(v >> 24));
  out.push_back((char)((v >> 16) & 0xff));
  out.push_back((char)((v >> 8) & 0xff));
  out.push_back((char)(v & 0xff));
}

std::string serialize_batch(const Overlay& ov) {
  std::string body;
  uint8_t kb[8];
  for (const auto& [name, table] : ov.tables) {
    for (const auto& [key, pv] : table) {
      body.push_back((char)(pv.first ? kOpPut : kOpDel));
      append_u16(body, (uint16_t)name.size());
      body += name;
      u64_to_key(key, kb);
      if (pv.first) {
        append_u16(body, 8);
        append_u32(body, (uint32_t)pv.second.size());
        body.append((const char*)kb, 8);
        body += pv.second;
      } else {
        append_u16(body, 8);
        body.append((const char*)kb, 8);
      }
    }
  }
  std::string out;
  out.append(kMagic, 4);
  out.push_back((char)kLogVersion);
  append_u32(out, (uint32_t)body.size());
  out += body;
  return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

Env* hny_open(const char* dir, uint64_t map_size) {
  auto* env = new Env();
  std::string d(dir);
  ::mkdir(d.c_str(), 0755);
  env->log_path = d + "/hannoy.log";
  env->snap_path = d + "/hannoy.snap";
  env->map_size = map_size;
  if (!replay_log(env)) {
    delete env;
    return nullptr;
  }
  // one owning process per environment: the append-only log has no
  // cross-process coordination (unlike LMDB's shared locks); a second
  // writer would interleave batches and corrupt the tail. The lock lives
  // on a sidecar file (not the log fd) so compaction's rename of the log
  // can never drop the exclusivity guarantee.
  std::string lock_path = d + "/hannoy.lock";
  env->lock_fd = ::open(lock_path.c_str(), O_CREAT | O_RDWR, 0644);
  if (env->lock_fd < 0 || flock(env->lock_fd, LOCK_EX | LOCK_NB) != 0) {
    if (env->lock_fd >= 0) ::close(env->lock_fd);
    delete env;
    return nullptr;
  }
  env->log = fopen(env->log_path.c_str(), "ab");
  if (!env->log) {
    ::close(env->lock_fd);
    delete env;
    return nullptr;
  }
  return env;
}

void hny_close(Env* env) {
  if (!env) return;
  if (env->log) fclose(env->log);
  if (env->lock_fd >= 0) ::close(env->lock_fd);
  delete env;
}

uint64_t hny_gen_id(Env* env) { return env->gen->gen_id; }
uint64_t hny_live_bytes(Env* env) { return env->live_bytes.load(); }

Txn* hny_ro_begin(Env* env) {
  auto* t = new Txn{env, nullptr, nullptr};
  std::lock_guard<std::mutex> g(env->swap_mu);
  t->gen = env->gen;
  return t;
}

Txn* hny_rw_begin(Env* env) {
  env->write_mu.lock();
  auto* t = new Txn{env, nullptr, new Overlay()};
  {
    std::lock_guard<std::mutex> g(env->swap_mu);
    t->gen = env->gen;
  }
  return t;
}

void hny_ro_end(Txn* t) { delete t; }

void hny_rw_abort(Txn* t) {
  t->env->write_mu.unlock();
  delete t->overlay;
  delete t;
}

// returns 0 ok, -1 full, -2 io error
int hny_put(Txn* t, const char* name, const uint8_t* key, const uint8_t* val,
            uint32_t vlen) {
  uint64_t k = key_to_u64(key);
  t->overlay->bytes += 24 + vlen;
  if (t->overlay->bytes + t->env->live_bytes.load() > t->env->map_size) return -1;
  (*t->overlay).tables[name][k] = {true, std::string((const char*)val, vlen)};
  return 0;
}

// Batched put: n records with 8-byte keys packed in `keys` and values
// concatenated in `vals` at offsets `val_offs` (n+1 entries, bytes).
// One C call replaces n ctypes round trips — the link-flush hot path.
// returns 0 ok, -1 full.
int hny_put_many(Txn* t, const char* name, const uint8_t* keys,
                 const uint8_t* vals, const uint64_t* val_offs, int64_t n) {
  auto& table = t->overlay->tables[name];
  uint64_t bytes = t->overlay->bytes;
  for (int64_t i = 0; i < n; i++) {
    uint64_t len = val_offs[i + 1] - val_offs[i];
    bytes += 24 + len;
  }
  if (bytes + t->env->live_bytes.load() > t->env->map_size) return -1;
  t->overlay->bytes = bytes;
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = key_to_u64(keys + i * 8);
    uint64_t len = val_offs[i + 1] - val_offs[i];
    table[k] = {true, std::string((const char*)vals + val_offs[i], len)};
  }
  return 0;
}

// returns 1 if key existed (snapshot ∪ overlay view), else 0
int hny_del(Txn* t, const char* name, const uint8_t* key) {
  uint64_t k = key_to_u64(key);
  int existed = 0;
  auto ot = t->overlay->tables.find(name);
  bool in_overlay = false;
  if (ot != t->overlay->tables.end()) {
    auto it = ot->second.find(k);
    if (it != ot->second.end()) {
      existed = it->second.first ? 1 : 0;
      in_overlay = true;
    }
  }
  if (!in_overlay) {
    auto gt = t->gen->tables.find(name);
    if (gt != t->gen->tables.end() && gt->second.find(k) >= 0) existed = 1;
  }
  (*t->overlay).tables[name][k] = {false, std::string()};
  return existed;
}

// Batched tombstone write: marks n u64 keys deleted in the overlay.
// The journal-clear path — replaces n hny_del round trips
// (existence checks are skipped; callers scanned the keys they delete).
int hny_del_many(Txn* t, const char* name, const uint64_t* keys, int64_t n) {
  auto& table = t->overlay->tables[name];
  for (int64_t i = 0; i < n; i++) table[keys[i]] = {false, std::string()};
  return 0;
}

// returns value length, or -1 if absent. Copies up to cap bytes into out.
int64_t hny_get(Txn* t, const char* name, const uint8_t* key, uint8_t* out,
                uint64_t cap) {
  uint64_t k = key_to_u64(key);
  const std::string* val = nullptr;
  if (t->overlay) {
    auto ot = t->overlay->tables.find(name);
    if (ot != t->overlay->tables.end()) {
      auto it = ot->second.find(k);
      if (it != ot->second.end()) {
        if (!it->second.first) return -1;
        val = &it->second.second;
      }
    }
  }
  if (!val) {
    auto gt = t->gen->tables.find(name);
    if (gt == t->gen->tables.end()) return -1;
    int64_t i = gt->second.find(k);
    if (i < 0) return -1;
    val = &gt->second.values[i];
  }
  uint64_t n = std::min<uint64_t>(cap, val->size());
  if (out && n) memcpy(out, val->data(), n);
  return (int64_t)val->size();
}

// Prefix scan: fills up to cap keys (u64 host order) that fall inside
// [lo, hi); returns the number written and sets *more if truncated.
// Write transactions see their overlay merged in.
// hi == 0 means "no upper bound" (callers' full-range scans wrap 2^64
// through the u64 ABI; a literal [lo, 0) range is vacuous anyway).
int64_t hny_scan_keys(Txn* t, const char* name, uint64_t lo, uint64_t hi,
                      uint64_t* out_keys, int64_t cap, int* more) {
  *more = 0;
  std::vector<uint64_t> merged;
  auto gt = t->gen->tables.find(name);
  if (gt != t->gen->tables.end()) {
    const auto& keys = gt->second.keys;
    auto a = std::lower_bound(keys.begin(), keys.end(), lo);
    auto b = hi ? std::lower_bound(keys.begin(), keys.end(), hi) : keys.end();
    merged.assign(a, b);
  }
  if (t->overlay) {
    auto ot = t->overlay->tables.find(name);
    if (ot != t->overlay->tables.end()) {
      for (auto it = ot->second.lower_bound(lo);
           it != ot->second.end() && (hi == 0 || it->first < hi); ++it) {
        auto pos = std::lower_bound(merged.begin(), merged.end(), it->first);
        bool present = pos != merged.end() && *pos == it->first;
        if (it->second.first) {
          if (!present) merged.insert(pos, it->first);
        } else if (present) {
          merged.erase(pos);
        }
      }
    }
  }
  int64_t n = std::min<int64_t>((int64_t)merged.size(), cap);
  memcpy(out_keys, merged.data(), n * sizeof(uint64_t));
  if ((int64_t)merged.size() > cap) *more = 1;
  return n;
}

// Bulk (key, value) range scan: fills up to `cap` entries whose keys fall
// in [lo, hi), concatenating values into `out_vals` (capacity vals_cap
// bytes) with per-entry lengths in `out_lens`. Stops early when the next
// value would overflow vals_cap and sets *more; the caller resumes with
// lo = last_key + 1. Write transactions see their overlay merged in.
// Replaces the per-key hny_get round trips of prefix iteration — the
// journal-scan / graph-load path.
int64_t hny_scan_vals(Txn* t, const char* name, uint64_t lo, uint64_t hi,
                      uint64_t* out_keys, uint32_t* out_lens,
                      uint8_t* out_vals, uint64_t vals_cap, int64_t cap,
                      int* more) {
  *more = 0;
  const Table* table = nullptr;
  auto gt = t->gen->tables.find(name);
  if (gt != t->gen->tables.end()) table = &gt->second;
  const std::map<uint64_t, std::pair<bool, std::string>>* ov = nullptr;
  if (t->overlay) {
    auto ot = t->overlay->tables.find(name);
    if (ot != t->overlay->tables.end()) ov = &ot->second;
  }
  size_t gi = 0, gn = 0;
  if (table) {
    gi = std::lower_bound(table->keys.begin(), table->keys.end(), lo) -
         table->keys.begin();
    gn = hi ? std::lower_bound(table->keys.begin(), table->keys.end(), hi) -
                  table->keys.begin()
            : table->keys.size();
  }
  auto oi = ov ? ov->lower_bound(lo) : std::map<uint64_t, std::pair<bool, std::string>>::const_iterator();
  int64_t n = 0;
  uint64_t used = 0;
  while (true) {
    bool g_ok = table && gi < gn;
    bool o_ok = ov && oi != ov->end() && (hi == 0 || oi->first < hi);
    if (!g_ok && !o_ok) break;
    uint64_t key;
    const std::string* val = nullptr;
    if (o_ok && (!g_ok || oi->first <= table->keys[gi])) {
      key = oi->first;
      if (g_ok && table->keys[gi] == key) gi++;  // overlay shadows base
      if (oi->second.first) val = &oi->second.second;
      ++oi;
      if (!val) continue;  // tombstone
    } else {
      key = table->keys[gi];
      val = &table->values[gi];
      gi++;
    }
    if (n >= cap || used + val->size() > vals_cap) {
      *more = 1;
      break;
    }
    out_keys[n] = key;
    out_lens[n] = (uint32_t)val->size();
    memcpy(out_vals + used, val->data(), val->size());
    used += val->size();
    n++;
  }
  return n;
}

// Commit: append batch + fsync, then publish the next generation.
// returns 0 ok, -2 io error.
int hny_commit(Txn* t) {
  Env* env = t->env;
  auto t0 = std::chrono::steady_clock::now();
  std::string batch = serialize_batch(*t->overlay);
  auto t1 = std::chrono::steady_clock::now();
  // Record the pre-batch offset so a failed append can be rolled back —
  // torn bytes left mid-log would make replay_log truncate away *later*
  // successfully-committed batches on the next open.
  fseek(env->log, 0, SEEK_END);
  long pre = ftell(env->log);
  if (fwrite(batch.data(), 1, batch.size(), env->log) != batch.size() ||
      fflush(env->log) != 0 || fsync(fileno(env->log)) != 0) {
    clearerr(env->log);
    if (pre >= 0 && ftruncate(fileno(env->log), pre) == 0) {
      fseek(env->log, 0, SEEK_END);
      fsync(fileno(env->log));
    }
    env->write_mu.unlock();
    delete t->overlay;
    delete t;
    return -2;
  }
  auto t2 = std::chrono::steady_clock::now();

  auto next = std::make_shared<Generation>();
  next->gen_id = env->gen->gen_id + 1;
  next->tables = env->gen->tables;  // copy (tables are value types)
  uint64_t live = env->live_bytes.load();
  for (auto& [name, ov] : t->overlay->tables)
    merge_into(next->tables[name], ov, live);
  env->live_bytes = live;
  {
    std::lock_guard<std::mutex> g(env->swap_mu);
    env->gen = next;
  }
  auto t3 = std::chrono::steady_clock::now();
  {
    std::lock_guard<std::mutex> g(env->stats_mu);
    env->last_commit[0] = batch.size();
    env->last_commit[1] = ns_between(t0, t1);
    env->last_commit[2] = ns_between(t1, t2);
    env->last_commit[3] = ns_between(t2, t3);
  }
  env->write_mu.unlock();
  delete t->overlay;
  delete t;
  return 0;
}

// The last successful commit of this environment: out = {batch bytes,
// serialize ns, log ns (write + flush + fsync), publish ns (the copy of the
// committed tables, the merge and the swap)}; zeros before the first.
void hny_last_commit_stats(Env* env, uint64_t out[4]) {
  std::lock_guard<std::mutex> g(env->stats_mu);
  memcpy(out, env->last_commit, sizeof(env->last_commit));
}

uint64_t hny_log_size(Env* env) {
  struct stat st;
  return (stat(env->log_path.c_str(), &st) == 0) ? (uint64_t)st.st_size : 0;
}

uint64_t hny_snap_covered(Env* env) { return env->snap_covered.load(); }

// Write the reopen snapshot for the current committed state (see the
// snapshot sidecar comment above). returns 0 ok, -2 io error.
int hny_snapshot(Env* env) {
  std::lock_guard<std::mutex> g(env->write_mu);
  return write_snapshot_locked(env);
}

// Compaction: rewrite the log with only live entries (atomic rename).
int hny_compact(Env* env) {
  std::lock_guard<std::mutex> g(env->write_mu);
  // the compacted log has a brand-new prefix — the old snapshot can never
  // validate against it; drop it up front so a crash mid-compact leaves a
  // plain full-replay store
  unlink(env->snap_path.c_str());
  env->snap_covered = 0;
  GenPtr gen;
  {
    std::lock_guard<std::mutex> s(env->swap_mu);
    gen = env->gen;
  }
  Overlay all;
  for (const auto& [name, table] : gen->tables) {
    auto& ov = all.tables[name];
    for (size_t i = 0; i < table.keys.size(); i++)
      ov[table.keys[i]] = {true, table.values[i]};
  }
  std::string batch = serialize_batch(all);
  std::string tmp = env->log_path + ".compact";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -2;
  if (fwrite(batch.data(), 1, batch.size(), f) != batch.size() ||
      fflush(f) != 0 || fsync(fileno(f)) != 0) {
    fclose(f);
    return -2;
  }
  fclose(f);
  fclose(env->log);
  // exclusivity is held by the sidecar lock fd throughout — the rename
  // window cannot admit a second writer
  if (rename(tmp.c_str(), env->log_path.c_str()) != 0) {
    env->log = fopen(env->log_path.c_str(), "ab");
    return env->log ? -2 : -3;
  }
  env->log = fopen(env->log_path.c_str(), "ab");
  if (!env->log) return -3;
  // re-seed the reopen snapshot for the fresh prefix (best-effort: a
  // failure only costs a full replay on the next open)
  write_snapshot_locked(env);
  return 0;
}

// Bulk item staging (hot path for graph loads): scans [lo, hi) and copies
// each value's bytes after skipping `skip` header bytes into out (row-major,
// fixed row_bytes per value; shorter values zero-pad). Fills out_keys with
// the u64 keys. Returns rows written, or -3 if a row exceeds row_bytes.
int64_t hny_bulk_rows(Txn* t, const char* name, uint64_t lo, uint64_t hi,
                      uint32_t skip, uint8_t* out, uint64_t row_bytes,
                      uint64_t* out_keys, int64_t cap) {
  auto gt = t->gen->tables.find(name);
  if (gt == t->gen->tables.end()) return 0;
  const Table& table = gt->second;
  auto a = std::lower_bound(table.keys.begin(), table.keys.end(), lo);
  auto b = hi ? std::lower_bound(table.keys.begin(), table.keys.end(), hi)
              : table.keys.end();
  int64_t n = 0;
  for (auto it = a; it != b && n < cap; ++it, ++n) {
    size_t idx = it - table.keys.begin();
    const std::string& v = table.values[idx];
    size_t len = v.size() > skip ? v.size() - skip : 0;
    if (len > row_bytes) return -3;
    memcpy(out + n * row_bytes, v.data() + skip, len);
    if (len < row_bytes) memset(out + n * row_bytes + len, 0, row_bytes - len);
    out_keys[n] = *it;
  }
  return n;
}

}  // extern "C"
