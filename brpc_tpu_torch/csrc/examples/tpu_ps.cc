// tpu_ps at Llama-3-8B's embedding table: the native parameter server of
// cpp/examples/tpu_ps.cc (BASELINE.json's config 5, "tpu_ps_c++") at full
// width, through the native core's own entry points and a PJRT plugin, with
// no Python anywhere in the process.
//
//  - PjrtClient::Create on the plugin (--plugin, else $BRT_PJRT_PLUGIN),
//    with at least --shards devices;
//  - one Server a shard, each with a PsShardService whose table (rows /
//    shards rows of --dim f32, drawn in C++ from --seed) is staged with
//    StageToDeviceShaped onto device s and kept there behind a registry
//    handle;
//  - Lookup: the ids staged, MlirGatherRowsF32 executed, the rows fetched
//    with StageFromDevice into the response;
//  - Push: ids, gradients and lr staged, MlirScatterSubF32 executed, the
//    updated table's handle swapped in;
//  - a client that splits each batch of --k Zipf(1.1) ids by shard (ranks
//    through a seeded permutation of the rows, drawn as numpy's zipf) and
//    calls the shards at once: kWarmup steps, then --steps timed, each a
//    Lookup and a Push of seeded gradients for the same ids;
//  - then AllReduceSum and AllGather of --k x --dim float blocks over R
//    members for every power of two R up to the client's device count, on
//    a CollectiveChannel with the client and no RPC sub-channels (a device
//    failure fails the call), last_used_device() asserted after each.
//
// Checks, in the program: every Lookup's rows and both tables after the
// last Push (fetched back) bit-equal to a host model that applies each
// Push in batch order (row = row - lr * grad, each step rounded as f32);
// each all-reduce bit-equal to the replica-order sum from +0.0f, each
// all-gather to the concatenation; every handle released and the plugin's
// live-buffer count 0 at the end. It prints one JSON line (times in ms as
// median, min and max; the plugin's launches of each program; the checks)
// and exits 0 only when every check holds.
//
//   tpu_ps --plugin PATH [--rows 128256 --dim 4096 --shards 2 --k 2048
//          --steps 8 --seed 0]
#include <dlfcn.h>

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "base/time.h"
#include "cluster/collective_channel.h"
#include "device/pjrt_device.h"
#include "device/pjrt_executable.h"
#include "fiber/fiber.h"
#include "fiber/sync.h"
#include "rpc/channel.h"
#include "rpc/server.h"

using namespace brt;

namespace {

constexpr float kLr = 0.05f;
constexpr double kZipf = 1.1;
constexpr int kWarmup = 2;  // untimed steps before the timed ones
constexpr int kCollectiveCalls = 5;  // timed, after one warm-up each

struct Flags {
  int64_t rows = 128256;  // Llama-3-8B's vocabulary
  int64_t dim = 4096;
  int shards = 2;
  int64_t k = 2048;
  int steps = 8;
  uint64_t seed = 0;
  std::string plugin;
};

bool ParseFlags(int argc, char** argv, Flags* f) {
  if (const char* env = getenv("BRT_PJRT_PLUGIN")) f->plugin = env;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    if (i + 1 >= argc) return false;
    const char* v = argv[++i];
    if (a == "--rows") f->rows = atoll(v);
    else if (a == "--dim") f->dim = atoll(v);
    else if (a == "--shards") f->shards = atoi(v);
    else if (a == "--k") f->k = atoll(v);
    else if (a == "--steps") f->steps = atoi(v);
    else if (a == "--seed") f->seed = strtoull(v, nullptr, 10);
    else if (a == "--plugin") f->plugin = v;
    else return false;
  }
  return !f->plugin.empty() && f->rows > 0 && f->dim > 0 && f->shards > 0 &&
         f->rows % f->shards == 0 && f->k > 0 && f->steps > 0;
}

uint64_t SplitMix(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// A float in [-scale, scale) from (stream, index), on 2^24 steps.
float Draw(uint64_t stream, uint64_t i, float scale) {
  const int64_t u = int64_t(SplitMix(stream ^ SplitMix(i)) >> 40);
  return float(u - (int64_t(1) << 23)) * (scale / 8388608.0f);
}

// out[i] = Draw(stream, i, scale) on every core.
void Fill(float* out, size_t n, uint64_t stream, float scale) {
  const size_t parts = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> ts;
  for (size_t p = 0; p < parts; ++p) {
    ts.emplace_back([=] {
      for (size_t i = n * p / parts; i < n * (p + 1) / parts; ++i) {
        out[i] = Draw(stream, i, scale);
      }
    });
  }
  for (auto& t : ts) t.join();
}

// numpy's zipf (random_zipf in its distributions.c): rejection sampling.
int64_t Zipf(std::mt19937_64& rng, double a) {
  auto uniform = [&rng] { return double(rng() >> 11) * 0x1.0p-53; };
  const double am1 = a - 1.0, b = std::pow(2.0, am1);
  for (;;) {
    const double u = 1.0 - uniform(), v = uniform();
    const double x = std::floor(std::pow(u, -1.0 / am1));
    if (x > 9.2e18 || x < 1.0) continue;
    const double t = std::pow(1.0 + 1.0 / x, am1);
    if (v * x * (t - 1.0) / (b - 1.0) <= t / b) return int64_t(x);
  }
}

struct Stat {
  double median = 0, min = 0, max = 0;
};

Stat Of(std::vector<double> v) {
  Stat s;
  if (v.empty()) return s;
  std::sort(v.begin(), v.end());
  const size_t n = v.size();
  s.median = n % 2 ? v[n / 2] : (v[n / 2 - 1] + v[n / 2]) / 2;
  s.min = v.front();
  s.max = v.back();
  return s;
}

std::string Quoted(const std::string& s) {
  std::string q = "\"";
  for (char c : s) {
    if (c == '"' || c == '\\') q += '\\';
    q += (c == '\n' || c == '\t') ? ' ' : c;
  }
  return q + "\"";
}

std::string Json(const Stat& s) {
  char b[160];
  snprintf(b, sizeof(b), "{\"median\": %.4f, \"min\": %.4f, \"max\": %.4f}",
           s.median, s.min, s.max);
  return b;
}

double MsSince(int64_t t0_us) { return double(monotonic_us() - t0_us) / 1e3; }

IOBuf OwnedBlock(void* data, size_t n) {
  IOBuf b;
  b.append_user_data(data, n, [](void* p, void*) { free(p); }, nullptr);
  return b;
}

// Wire format (as cpp/examples/tpu_ps.cc):
//   Lookup req: u32 k + i32 ids[k]                     rsp: f32 rows[k*dim]
//   Push   req: u32 k + i32 ids[k] + f32 grads[k*dim]  rsp: "OK"
class PsShardService : public Service {
 public:
  PsShardService(PjrtClient* client, int device, int64_t rows, int64_t dim,
                 const float* init)
      : client_(client), device_(device), rows_(rows), dim_(dim) {
    const size_t bytes = size_t(rows) * size_t(dim) * 4;
    void* copy = malloc(bytes);
    memcpy(copy, init, bytes);
    std::string err;
    const int64_t t0 = monotonic_us();
    table_ = client_->StageToDeviceShaped(OwnedBlock(copy, bytes), device_,
                                          PjrtClient::DType::kF32,
                                          {rows, dim}, &err);
    stage_ms_ = MsSince(t0);
    if (table_ == 0) fprintf(stderr, "staging the table: %s\n", err.c_str());
  }

  uint64_t table() const { return table_; }
  double stage_ms() const { return stage_ms_; }

  // Releases the table; the executables go with the service.
  void Close() {
    std::lock_guard<std::mutex> g(table_mu_);
    if (table_ != 0) DeviceBufferRegistry::Release(table_);
    table_ = 0;
  }

  // Per-call milliseconds of the timed calls: Lookup's staging, kernel
  // (Execute until its event) and fetch; Push's staging and kernel.
  void ResetSplits() {
    std::lock_guard<std::mutex> g(mu_);
    splits_.clear();
  }
  std::map<std::string, std::vector<double>> splits() {
    std::lock_guard<std::mutex> g(mu_);
    return splits_;
  }

  void CallMethod(const std::string& method, Controller* cntl,
                  const IOBuf& request, IOBuf* response,
                  Closure done) override {
    uint32_t k = 0;
    request.copy_to(&k, 4);
    const size_t ids_bytes = size_t(k) * 4;
    const size_t grad_bytes = ids_bytes * size_t(dim_);
    IOBuf body = request, head, ids, grads;
    body.cutn(&head, 4);
    body.cutn(&ids, ids_bytes);
    std::string err;
    if (method == "Lookup" && request.size() == 4 + ids_bytes) {
      int64_t t0 = monotonic_us();
      const uint64_t ids_h = client_->StageToDeviceShaped(
          ids, device_, PjrtClient::DType::kS32, {int64_t(k)}, &err);
      const double stage = MsSince(t0);
      PjrtExecutable* exe = Cached(&gather_, k, true, &err);
      std::vector<std::vector<uint64_t>> outs;
      t0 = monotonic_us();
      int rc = EIO;
      if (ids_h != 0 && exe != nullptr) {
        std::lock_guard<std::mutex> g(table_mu_);
        rc = exe->Execute({{table_, ids_h}}, &outs, &err);
      }
      const double kernel = MsSince(t0);
      if (rc == 0) {
        IOBuf rows;
        t0 = monotonic_us();
        if (client_->StageFromDevice(outs[0][0], &rows, &err) == 0) {
          response->append(rows);  // shares the landed block
          Note({{"lookup_stage", stage}, {"lookup_kernel", kernel},
                {"lookup_fetch", MsSince(t0)}});
        } else {
          cntl->SetFailed(EINTERNAL, "%s", err.c_str());
        }
        DeviceBufferRegistry::Release(outs[0][0]);
      } else {
        cntl->SetFailed(EINTERNAL, "%s", err.c_str());
      }
      if (ids_h != 0) DeviceBufferRegistry::Release(ids_h);
    } else if (method == "Push" &&
               request.size() == 4 + ids_bytes + grad_bytes) {
      grads = body;
      int64_t t0 = monotonic_us();
      IOBuf lr;
      lr.append(&kLr, 4);
      const uint64_t ids_h = client_->StageToDeviceShaped(
          ids, device_, PjrtClient::DType::kS32, {int64_t(k)}, &err);
      const uint64_t grads_h = client_->StageToDeviceShaped(
          grads, device_, PjrtClient::DType::kF32, {int64_t(k), dim_}, &err);
      const uint64_t lr_h = client_->StageToDeviceShaped(
          lr, device_, PjrtClient::DType::kF32, {}, &err);
      const double stage = MsSince(t0);
      PjrtExecutable* exe = Cached(&scatter_, k, false, &err);
      std::vector<std::vector<uint64_t>> outs;
      if (ids_h != 0 && grads_h != 0 && lr_h != 0 && exe != nullptr) {
        std::lock_guard<std::mutex> g(table_mu_);
        t0 = monotonic_us();
        if (exe->Execute({{table_, ids_h, grads_h, lr_h}}, &outs, &err) ==
            0) {
          DeviceBufferRegistry::Release(table_);
          table_ = outs[0][0];  // the updated table stays on the device
          response->append("OK");
          Note({{"push_stage", stage}, {"push_kernel", MsSince(t0)}});
        } else {
          cntl->SetFailed(EINTERNAL, "%s", err.c_str());
        }
      } else {
        cntl->SetFailed(EINTERNAL, "%s", err.c_str());
      }
      for (uint64_t h : {ids_h, grads_h, lr_h}) {
        if (h != 0) DeviceBufferRegistry::Release(h);
      }
    } else {
      cntl->SetFailed(EREQUEST, "bad %s request of %zu bytes",
                      method.c_str(), request.size());
    }
    done();
  }

 private:
  PjrtExecutable* Cached(std::map<uint32_t, std::unique_ptr<PjrtExecutable>>*
                             cache,
                         uint32_t k, bool gather, std::string* err) {
    std::lock_guard<std::mutex> g(mu_);
    auto& slot = (*cache)[k];
    if (!slot) {
      slot = PjrtExecutable::Compile(
          client_,
          gather ? MlirGatherRowsF32(size_t(rows_), size_t(dim_), k)
                 : MlirScatterSubF32(size_t(rows_), size_t(dim_), k),
          1, err);
    }
    return slot.get();
  }

  void Note(std::initializer_list<std::pair<const char*, double>> times) {
    std::lock_guard<std::mutex> g(mu_);
    for (const auto& [name, ms] : times) splits_[name].push_back(ms);
  }

  PjrtClient* client_;
  const int device_;
  const int64_t rows_, dim_;
  std::mutex table_mu_;  // Push swaps the table a Lookup reads
  uint64_t table_ = 0;
  double stage_ms_ = 0;
  std::mutex mu_;
  std::map<uint32_t, std::unique_ptr<PjrtExecutable>> gather_, scatter_;
  std::map<std::string, std::vector<double>> splits_;
};

// The host model: the whole table, updated as the shards update theirs.
struct HostModel {
  int64_t dim;
  std::vector<float> table;

  const float* row(int64_t id) const { return &table[size_t(id * dim)]; }
  void Push(const std::vector<int32_t>& ids, const std::vector<float>& g) {
    for (size_t i = 0; i < ids.size(); ++i) {
      float* r = &table[size_t(ids[i]) * size_t(dim)];
      const float* gi = &g[i * size_t(dim)];
      for (int64_t j = 0; j < dim; ++j) {
        const float step = kLr * gi[j];
        r[j] = r[j] - step;
      }
    }
  }
};

// Calls every shard that holds some of `ids` at once; the requests carry
// each shard's ids (local rows) in batch order, and for a Push their
// gradients. Fills `rows` (Lookup) in batch order. Returns "" or the error.
std::string CallShards(std::vector<std::unique_ptr<Channel>>& shards,
                       int64_t shard_rows, int64_t dim, const char* method,
                       const std::vector<int32_t>& ids,
                       const std::vector<float>* grads,
                       std::vector<float>* rows) {
  const int n = int(shards.size());
  std::vector<std::vector<size_t>> pos(static_cast<size_t>(n));
  for (size_t i = 0; i < ids.size(); ++i) {
    pos[size_t(ids[i] / shard_rows)].push_back(i);
  }
  std::vector<Controller> cntls(static_cast<size_t>(n));
  std::vector<IOBuf> rsps(static_cast<size_t>(n));
  int calls = 0;
  for (int s = 0; s < n; ++s) calls += !pos[size_t(s)].empty();
  CountdownEvent ev(calls);
  const size_t row_bytes = size_t(dim) * 4;
  for (int s = 0; s < n; ++s) {
    const std::vector<size_t>& p = pos[size_t(s)];
    if (p.empty()) continue;
    const uint32_t k = uint32_t(p.size());
    const size_t bytes = 4 + size_t(k) * 4 + (grads ? k * row_bytes : 0);
    char* req = static_cast<char*>(malloc(bytes));
    memcpy(req, &k, 4);
    int32_t* local = reinterpret_cast<int32_t*>(req + 4);
    for (size_t j = 0; j < p.size(); ++j) {
      local[j] = int32_t(ids[p[j]] % shard_rows);
      if (grads) {
        memcpy(req + 4 + size_t(k) * 4 + j * row_bytes,
               &(*grads)[p[j] * size_t(dim)], row_bytes);
      }
    }
    cntls[size_t(s)].timeout_ms = 120000;
    shards[size_t(s)]->CallMethod("Ps", method, &cntls[size_t(s)],
                                  OwnedBlock(req, bytes), &rsps[size_t(s)],
                                  [&ev] { ev.signal(); });
  }
  ev.wait(-1);
  for (int s = 0; s < n; ++s) {
    const std::vector<size_t>& p = pos[size_t(s)];
    if (p.empty()) continue;
    if (cntls[size_t(s)].Failed()) {
      return std::string(method) + " on shard " + std::to_string(s) + ": " +
             cntls[size_t(s)].ErrorText();
    }
    if (rows == nullptr) continue;
    if (rsps[size_t(s)].size() != p.size() * row_bytes) {
      return "Lookup on shard " + std::to_string(s) + ": " +
             std::to_string(rsps[size_t(s)].size()) + " bytes";
    }
    for (size_t j = 0; j < p.size(); ++j) {
      rsps[size_t(s)].copy_to(&(*rows)[p[j] * size_t(dim)], row_bytes,
                              j * row_bytes);
    }
  }
  return "";
}

struct CollectiveRow {
  const char* op;
  int replicas;
  Stat ms;
  bool exact = true, device = true;
};

// AllReduceSum and AllGather over R members of n floats each, against the
// ordered host sum and the concatenation.
std::string RunCollectives(PjrtClient* client, int64_t n, uint64_t seed,
                           std::vector<CollectiveRow>* rows) {
  CollectiveChannelOptions opts;
  opts.device_client = client;  // and no RPC sub-channels: no fallback
  CollectiveChannel coll(opts);
  for (int r = 1; r <= client->addressable_device_count(); r *= 2) {
    std::vector<std::vector<float>> xs(static_cast<size_t>(r),
                                       std::vector<float>(size_t(n)));
    for (int m = 0; m < r; ++m) {
      Fill(xs[size_t(m)].data(), size_t(n), SplitMix(seed + 1000 + m), 1.0f);
    }
    std::vector<float> sum(static_cast<size_t>(n)), cat;
    for (int64_t i = 0; i < n; ++i) {
      float acc = 0.0f;
      for (int m = 0; m < r; ++m) acc = acc + xs[size_t(m)][size_t(i)];
      sum[size_t(i)] = acc;
    }
    for (const auto& x : xs) cat.insert(cat.end(), x.begin(), x.end());
    for (int op = 0; op < 2; ++op) {
      CollectiveRow row{op == 0 ? "all_reduce_sum" : "all_gather", r};
      const std::vector<float>& want = op == 0 ? sum : cat;
      std::vector<double> ms;
      for (int call = 0; call <= kCollectiveCalls; ++call) {
        std::vector<IOBuf> inputs(static_cast<size_t>(r));
        for (int m = 0; m < r; ++m) {
          inputs[size_t(m)].append(xs[size_t(m)].data(), size_t(n) * 4);
        }
        IOBuf out;
        std::string err;
        const int64_t t0 = monotonic_us();
        const int rc = op == 0 ? coll.AllReduceSum(inputs, &out, &err)
                               : coll.AllGather(inputs, &out, &err);
        const double t = MsSince(t0);
        if (rc != 0) {
          return std::string(row.op) + " over " + std::to_string(r) + ": " +
                 err;
        }
        if (call > 0) ms.push_back(t);
        row.device = row.device && coll.last_used_device();
        std::vector<float> got(out.size() / 4);
        out.copy_to(got.data(), out.size());
        row.exact = row.exact && got.size() == want.size() &&
                    memcmp(got.data(), want.data(), want.size() * 4) == 0;
        if (out.user_meta_at(0) != 0) {
          DeviceBufferRegistry::Release(out.user_meta_at(0));
        }
      }
      row.ms = Of(ms);
      rows->push_back(row);
    }
  }
  return "";
}

}  // namespace

int main(int argc, char** argv) {
  Flags f;
  if (!ParseFlags(argc, argv, &f)) {
    fprintf(stderr,
            "usage: %s --plugin PATH [--rows N --dim N --shards N --k N "
            "--steps N --seed N] (rows a multiple of shards)\n",
            argv[0]);
    return 2;
  }
  fiber_init(8);
  std::string err;
  PjrtClient::Options popts;
  popts.plugin_path = f.plugin;
  auto client = PjrtClient::Create(popts, &err);
  if (client != nullptr && client->addressable_device_count() < f.shards) {
    client.reset();
    popts.create_options.push_back(
        PjrtClient::Option::Int("num_devices", f.shards));
    client = PjrtClient::Create(popts, &err);
  }
  if (client == nullptr) {
    fprintf(stderr, "no PJRT client on %s: %s\n", f.plugin.c_str(),
            err.c_str());
    return 1;
  }
  const int64_t shard_rows = f.rows / f.shards;
  printf("platform %s, %d devices; table %lld x %lld f32 in %d shards\n",
         client->platform_name().c_str(), client->addressable_device_count(),
         (long long)f.rows, (long long)f.dim, f.shards);
  fflush(stdout);

  HostModel host{f.dim, std::vector<float>(size_t(f.rows * f.dim))};
  int64_t t0 = monotonic_us();
  Fill(host.table.data(), host.table.size(), SplitMix(f.seed), 0.02f);
  const double draw_ms = MsSince(t0);

  std::vector<std::unique_ptr<PsShardService>> svcs;
  std::vector<std::unique_ptr<Server>> servers;
  std::vector<std::unique_ptr<Channel>> shards;
  ChannelOptions copts;
  copts.timeout_ms = 120000;
  copts.max_retry = 0;  // a Push is applied once
  double stage_ms = 0;
  for (int s = 0; s < f.shards; ++s) {
    svcs.push_back(std::make_unique<PsShardService>(
        client.get(), s, shard_rows, f.dim, host.row(s * shard_rows)));
    if (svcs.back()->table() == 0) return 1;
    stage_ms += svcs.back()->stage_ms();
    servers.push_back(std::make_unique<Server>());
    servers.back()->AddService(svcs.back().get(), "Ps");
    if (servers.back()->Start("127.0.0.1:0", nullptr) != 0) return 1;
    shards.push_back(std::make_unique<Channel>());
    if (shards.back()->Init(servers.back()->listen_address(), &copts) != 0) {
      return 1;
    }
  }

  // Zipf ranks onto a seeded permutation of the rows.
  std::mt19937_64 rng(f.seed);
  std::vector<int32_t> perm(static_cast<size_t>(f.rows));
  for (int64_t i = 0; i < f.rows; ++i) perm[size_t(i)] = int32_t(i);
  std::shuffle(perm.begin(), perm.end(), rng);

  bool lookups_exact = true;
  std::string failure;
  std::vector<double> lookup_ms, push_ms;
  std::vector<int32_t> ids(static_cast<size_t>(f.k));
  std::vector<float> rows(size_t(f.k * f.dim)), grads(rows.size());
  for (int step = 0; step < kWarmup + f.steps && failure.empty(); ++step) {
    if (step == kWarmup) {
      for (auto& svc : svcs) svc->ResetSplits();
    }
    for (int64_t i = 0; i < f.k; ++i) {
      ids[size_t(i)] = perm[size_t((Zipf(rng, kZipf) - 1) % f.rows)];
    }
    t0 = monotonic_us();
    failure = CallShards(shards, shard_rows, f.dim, "Lookup", ids, nullptr,
                         &rows);
    if (step >= kWarmup) lookup_ms.push_back(MsSince(t0));
    for (int64_t i = 0; i < f.k && failure.empty(); ++i) {
      lookups_exact = lookups_exact &&
                      memcmp(&rows[size_t(i * f.dim)], host.row(ids[size_t(i)]),
                             size_t(f.dim) * 4) == 0;
    }
    if (!failure.empty()) break;
    Fill(grads.data(), grads.size(), SplitMix(f.seed + 100 + step), 0.01f);
    t0 = monotonic_us();
    failure = CallShards(shards, shard_rows, f.dim, "Push", ids, &grads,
                         nullptr);
    if (step >= kWarmup) push_ms.push_back(MsSince(t0));
    host.Push(ids, grads);
  }

  // Both tables back from the device, against the host model.
  bool tables_exact = failure.empty();
  double fetch_ms = 0;
  for (int s = 0; s < f.shards && failure.empty(); ++s) {
    IOBuf got;
    t0 = monotonic_us();
    if (client->StageFromDevice(svcs[size_t(s)]->table(), &got, &err) != 0) {
      failure = "fetching shard " + std::to_string(s) + ": " + err;
      break;
    }
    fetch_ms += MsSince(t0);
    std::vector<float> table(got.size() / 4);
    got.copy_to(table.data(), got.size());
    tables_exact = tables_exact &&
                   table.size() == size_t(shard_rows * f.dim) &&
                   memcmp(table.data(), host.row(s * shard_rows),
                          table.size() * 4) == 0;
  }

  std::vector<CollectiveRow> coll;
  if (failure.empty()) {
    failure = RunCollectives(client.get(), f.k * f.dim, f.seed, &coll);
  }
  bool coll_exact = !coll.empty(), coll_device = !coll.empty();
  for (const CollectiveRow& r : coll) {
    coll_exact = coll_exact && r.exact;
    coll_device = coll_device && r.device;
  }

  std::map<std::string, std::vector<double>> splits;
  for (auto& svc : svcs) {
    for (auto& [name, v] : svc->splits()) {
      splits[name].insert(splits[name].end(), v.begin(), v.end());
    }
  }
  for (auto& s : servers) {
    s->Stop();
    s->Join();
  }
  for (auto& svc : svcs) svc->Close();
  svcs.clear();

  // The plugin's counters (the port's plugin exports them).
  void* lib = dlopen(f.plugin.c_str(), RTLD_NOW | RTLD_NOLOAD);
  using Launches = long long (*)(int);
  using Name = const char* (*)(int);
  using Live = long long (*)();
  auto launches = lib ? reinterpret_cast<Launches>(
                            dlsym(lib, "brt_pjrt_launches")) : nullptr;
  auto name = lib ? reinterpret_cast<Name>(
                        dlsym(lib, "brt_pjrt_program_name")) : nullptr;
  auto live = lib ? reinterpret_cast<Live>(
                        dlsym(lib, "brt_pjrt_live_buffers")) : nullptr;
  std::string launch_json = "{";
  for (int p = 0; launches && name && name(p) != nullptr; ++p) {
    launch_json += std::string(p ? ", " : "") + "\"" + name(p) +
                   "\": " + std::to_string(launches(p));
  }
  launch_json += "}";
  const long long live_buffers = live ? live() : -1;

  std::string coll_json = "[";
  for (size_t i = 0; i < coll.size(); ++i) {
    coll_json += std::string(i ? ", " : "") + "{\"op\": \"" + coll[i].op +
                 "\", \"replicas\": " + std::to_string(coll[i].replicas) +
                 ", \"n\": " + std::to_string(f.k * f.dim) +
                 ", \"ms\": " + Json(coll[i].ms) +
                 ", \"bit_equal\": " + (coll[i].exact ? "true" : "false") +
                 ", \"device_path\": " + (coll[i].device ? "true" : "false") +
                 "}";
  }
  coll_json += "]";
  std::string split_json = "{";
  for (auto& [n, v] : splits) {
    split_json += std::string(split_json.size() > 1 ? ", " : "") + "\"" + n +
                  "\": " + Json(Of(v));
  }
  split_json += "}";

  const bool ok = failure.empty() && lookups_exact && tables_exact &&
                  coll_exact && coll_device && live_buffers == 0;
  auto b = [](bool v) { return v ? "true" : "false"; };
  printf("{\"program\": \"tpu_ps\", \"platform\": \"%s\", \"devices\": %d, "
         "\"rows\": %lld, \"dim\": %lld, \"shards\": %d, \"k\": %lld, "
         "\"steps\": %d, \"warmup\": %d, \"seed\": %llu, "
         "\"table_draw_ms\": %.1f, \"table_stage_ms\": %.4f, "
         "\"table_fetch_ms\": %.4f, \"lookup_ms\": %s, \"push_ms\": %s, "
         "\"split_ms\": %s, \"collectives\": %s, \"launches\": %s, "
         "\"live_buffers\": %lld, \"checks\": {\"lookups_bit_equal\": %s, "
         "\"tables_bit_equal\": %s, \"collectives_bit_equal\": %s, "
         "\"collectives_on_device\": %s, \"live_buffers_zero\": %s}, "
         "\"error\": %s, \"ok\": %s}\n",
         client->platform_name().c_str(), client->addressable_device_count(),
         (long long)f.rows, (long long)f.dim, f.shards, (long long)f.k,
         f.steps, kWarmup, (unsigned long long)f.seed, draw_ms, stage_ms,
         fetch_ms, Json(Of(lookup_ms)).c_str(), Json(Of(push_ms)).c_str(),
         split_json.c_str(), coll_json.c_str(), launch_json.c_str(),
         live_buffers, b(lookups_exact), b(tables_exact), b(coll_exact),
         b(coll_device), b(live_buffers == 0), Quoted(failure).c_str(), b(ok));
  fflush(stdout);
  client.reset();
  return ok ? 0 : 1;
}
