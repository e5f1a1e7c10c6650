// The PJRT surface of the port's plugin (see plugin.h): exactly the entries
// of the API table that the native core's device layer calls, over a
// Backend. No CUDA here.
#include "plugin.h"

#include <atomic>
#include <cctype>
#include <climits>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <utility>

#include "third_party/pjrt/pjrt_c_api.h"

namespace brt_pjrt {

const char* ProgramName(Program p) {
  static const char* const kNames[kPrograms] = {
      "add", "reduce_sum", "all_reduce_sum", "all_gather", "gather_rows",
      "scatter_sub"};
  return kNames[int(p)];
}

void AllReduceSlice(int64_t n, int replicas, int d, int64_t* begin,
                    int64_t* end) {
  const int64_t per = n / replicas / kSliceFloats * kSliceFloats;
  *begin = d * per;
  *end = d == replicas - 1 ? n : (d + 1) * per;
}

namespace {

std::atomic<long long> g_launches[kPrograms];
std::atomic<long long> g_live_buffers{0};

// At exit, a process started with $BRT_PJRT_COUNTS_FILE set appends one
// JSON line to that file: its launches of each program and the buffers it
// left alive. Drivers read it for programs that print no counters.
struct CountsAtExit {
  ~CountsAtExit() {
    const char* path = getenv("BRT_PJRT_COUNTS_FILE");
    FILE* f = path != nullptr ? fopen(path, "a") : nullptr;
    if (f == nullptr) return;
    fprintf(f, "{");
    for (int p = 0; p < kPrograms; ++p) {
      fprintf(f, "\"%s\": %lld, ", ProgramName(Program(p)),
              g_launches[p].load());
    }
    fprintf(f, "\"live_buffers\": %lld}\n", g_live_buffers.load());
    fclose(f);
  }
} g_counts_at_exit;

// ---- errors ----

struct Error {
  std::string msg;
  PJRT_Error_Code code;
};

PJRT_Error* Err(const std::string& m,
                PJRT_Error_Code code = PJRT_Error_Code_INVALID_ARGUMENT) {
  return reinterpret_cast<PJRT_Error*>(new Error{"brt pjrt: " + m, code});
}

PJRT_Error* Internal(const std::string& m) {
  return Err(m, PJRT_Error_Code_INTERNAL);
}

void ErrorDestroy(PJRT_Error_Destroy_Args* a) {
  delete reinterpret_cast<Error*>(a->error);
}
void ErrorMessage(PJRT_Error_Message_Args* a) {
  auto* e = reinterpret_cast<const Error*>(a->error);
  a->message = e->msg.c_str();
  a->message_size = e->msg.size();
}
PJRT_Error* ErrorGetCode(PJRT_Error_GetCode_Args* a) {
  a->code = reinterpret_cast<const Error*>(a->error)->code;
  return nullptr;
}
PJRT_Error* PluginInitialize(PJRT_Plugin_Initialize_Args*) { return nullptr; }
PJRT_Error* PluginAttributes(PJRT_Plugin_Attributes_Args* a) {
  a->num_attributes = 0;
  a->attributes = nullptr;
  return nullptr;
}

// ---- events ----

// Shared by the PJRT_Event handle and the completion thread, so that a
// callback may destroy the handle while the thread still fires the rest.
struct EventState {
  std::mutex mu;
  std::condition_variable cv;
  bool ready = false;
  std::string error;
  std::vector<std::pair<PJRT_Event_OnReadyCallback, void*>> callbacks;

  void Fire(const std::string& err) {
    std::vector<std::pair<PJRT_Event_OnReadyCallback, void*>> cbs;
    {
      std::lock_guard<std::mutex> g(mu);
      ready = true;
      error = err;
      cbs.swap(callbacks);
    }
    cv.notify_all();
    for (auto& [cb, arg] : cbs) cb(err.empty() ? nullptr : Internal(err), arg);
  }
};

struct Event {
  std::shared_ptr<EventState> s;
};

PJRT_Event* ReadyEvent() {
  auto s = std::make_shared<EventState>();
  s->ready = true;
  return reinterpret_cast<PJRT_Event*>(new Event{std::move(s)});
}

EventState* StateOf(PJRT_Event* e) {
  return reinterpret_cast<Event*>(e)->s.get();
}

PJRT_Error* EventDestroy(PJRT_Event_Destroy_Args* a) {
  delete reinterpret_cast<Event*>(a->event);
  return nullptr;
}
PJRT_Error* EventIsReady(PJRT_Event_IsReady_Args* a) {
  EventState* s = StateOf(a->event);
  std::lock_guard<std::mutex> g(s->mu);
  a->is_ready = s->ready;
  return nullptr;
}
PJRT_Error* EventError(PJRT_Event_Error_Args* a) {
  EventState* s = StateOf(a->event);
  std::lock_guard<std::mutex> g(s->mu);
  if (!s->ready) return Err("PJRT_Event_Error on an event not ready yet");
  return s->error.empty() ? nullptr : Internal(s->error);
}
PJRT_Error* EventAwait(PJRT_Event_Await_Args* a) {
  EventState* s = StateOf(a->event);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait(lk, [s] { return s->ready; });
  return s->error.empty() ? nullptr : Internal(s->error);
}
PJRT_Error* EventOnReady(PJRT_Event_OnReady_Args* a) {
  EventState* s = StateOf(a->event);
  std::string err;
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (!s->ready) {
      s->callbacks.emplace_back(a->callback, a->user_arg);
      return nullptr;
    }
    err = s->error;
  }
  // Ready already: call back at once, on this thread, with no lock held.
  a->callback(err.empty() ? nullptr : Internal(err), a->user_arg);
  return nullptr;
}

// Waits for one device's markers in issue order and fires their events.
class Completer {
 public:
  explicit Completer(std::shared_ptr<Backend> backend)
      : backend_(std::move(backend)), thread_([this] { Run(); }) {}
  ~Completer() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    thread_.join();  // after every queued event has fired
  }

  void Watch(Marker m, std::shared_ptr<EventState> ev) {
    {
      std::lock_guard<std::mutex> g(mu_);
      queue_.emplace_back(m, std::move(ev));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::pair<Marker, std::shared_ptr<EventState>> item;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) return;
        item = std::move(queue_.front());
        queue_.pop_front();
      }
      const std::string err = backend_->Sync(item.first);
      backend_->Destroy(item.first);
      item.second->Fire(err);
    }
  }

  std::shared_ptr<Backend> backend_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::pair<Marker, std::shared_ptr<EventState>>> queue_;
  bool stop_ = false;
  std::thread thread_;  // last: starts once the members above exist
};

// ---- client and devices ----

struct Device {
  int id = 0;
};

struct Client {
  std::shared_ptr<Backend> backend;
  std::string platform;
  std::vector<Device> devices;
  std::vector<PJRT_Device*> device_ptrs;
  std::vector<std::unique_ptr<Completer>> completers;

  int IndexOf(PJRT_Device* d) const {
    for (size_t i = 0; i < device_ptrs.size(); ++i) {
      if (device_ptrs[i] == d) return int(i);
    }
    return -1;
  }

  // A PJRT event that is ready once the work issued to device d so far is
  // done, or nullptr with *err set.
  PJRT_Event* EventAfter(int d, std::string* err) {
    Marker m = nullptr;
    *err = backend->Record(d, &m);
    if (!err->empty()) return nullptr;
    auto s = std::make_shared<EventState>();
    completers[size_t(d)]->Watch(m, s);
    return reinterpret_cast<PJRT_Event*>(new Event{std::move(s)});
  }
};

PJRT_Error* ClientCreate(PJRT_Client_Create_Args* a) {
  // The device count: the num_devices option, else $BRT_PJRT_NUM_DEVICES
  // (for callers that pass no options, as the C API's brt_device_client_new),
  // else the backend's default.
  int n = -1;
  if (const char* env = getenv("BRT_PJRT_NUM_DEVICES")) {
    n = atoi(env);
    if (n < 1) return Err("BRT_PJRT_NUM_DEVICES must be a positive count");
  }
  for (size_t i = 0; i < a->num_options; ++i) {
    const PJRT_NamedValue& nv = a->create_options[i];
    if (std::string(nv.name, nv.name_size) != "num_devices") continue;
    if (nv.type != PJRT_NamedValue_kInt64 || nv.int64_value < 1 ||
        nv.int64_value > INT_MAX) {
      return Err("num_devices must be a positive int64");
    }
    n = int(nv.int64_value);
  }
  std::string error;
  std::shared_ptr<Backend> backend = MakeBackend(n, &error);
  if (backend == nullptr) return Err(error, PJRT_Error_Code_UNAVAILABLE);
  auto* c = new Client();
  c->backend = backend;
  c->platform = backend->platform();
  c->devices.resize(size_t(backend->device_count()));
  for (size_t i = 0; i < c->devices.size(); ++i) {
    c->devices[i].id = int(i);
    c->device_ptrs.push_back(reinterpret_cast<PJRT_Device*>(&c->devices[i]));
    c->completers.push_back(std::make_unique<Completer>(backend));
  }
  a->client = reinterpret_cast<PJRT_Client*>(c);
  return nullptr;
}
PJRT_Error* ClientDestroy(PJRT_Client_Destroy_Args* a) {
  // The completion threads drain first; buffers still alive keep the
  // backend (their memory is freed when they are destroyed).
  delete reinterpret_cast<Client*>(a->client);
  return nullptr;
}
PJRT_Error* ClientPlatformName(PJRT_Client_PlatformName_Args* a) {
  auto* c = reinterpret_cast<Client*>(a->client);
  a->platform_name = c->platform.c_str();
  a->platform_name_size = c->platform.size();
  return nullptr;
}
PJRT_Error* ClientAddressableDevices(PJRT_Client_AddressableDevices_Args* a) {
  auto* c = reinterpret_cast<Client*>(a->client);
  a->addressable_devices = c->device_ptrs.data();
  a->num_addressable_devices = c->device_ptrs.size();
  return nullptr;
}

// ---- buffers ----

size_t ElemSize(PJRT_Buffer_Type t) {
  switch (t) {
    case PJRT_Buffer_Type_PRED:
    case PJRT_Buffer_Type_S8:
    case PJRT_Buffer_Type_U8: return 1;
    case PJRT_Buffer_Type_S16:
    case PJRT_Buffer_Type_U16:
    case PJRT_Buffer_Type_F16:
    case PJRT_Buffer_Type_BF16: return 2;
    case PJRT_Buffer_Type_S32:
    case PJRT_Buffer_Type_U32:
    case PJRT_Buffer_Type_F32: return 4;
    case PJRT_Buffer_Type_S64:
    case PJRT_Buffer_Type_U64:
    case PJRT_Buffer_Type_F64: return 8;
    default: return 0;
  }
}

std::string Shape(PJRT_Buffer_Type t, const std::vector<int64_t>& dims) {
  std::string s = t == PJRT_Buffer_Type_F32   ? "f32["
                  : t == PJRT_Buffer_Type_S32 ? "i32["
                  : t == PJRT_Buffer_Type_U8  ? "u8["
                                              : "type " + std::to_string(t) +
                                                    " [";
  for (size_t i = 0; i < dims.size(); ++i) {
    s += (i ? "," : "") + std::to_string(dims[i]);
  }
  return s + "]";
}

// Dense row-major device memory on one device of one client.
struct Buffer {
  std::shared_ptr<Backend> backend;
  const Client* owner;
  int device;
  PJRT_Buffer_Type type;
  std::vector<int64_t> dims;
  std::vector<int64_t> minor_to_major;
  size_t bytes;
  void* ptr = nullptr;

  Buffer(const Client* c, int d, PJRT_Buffer_Type t,
         std::vector<int64_t> shape, size_t n)
      : backend(c->backend), owner(c), device(d), type(t),
        dims(std::move(shape)), bytes(n) {
    for (size_t i = 0; i < dims.size(); ++i) {
      minor_to_major.push_back(int64_t(dims.size() - 1 - i));
    }
    g_live_buffers.fetch_add(1, std::memory_order_relaxed);
  }
  ~Buffer() {
    if (ptr != nullptr) backend->Free(device, ptr);
    g_live_buffers.fetch_sub(1, std::memory_order_relaxed);
  }
  float* f32() const { return static_cast<float*>(ptr); }
  int32_t* i32() const { return static_cast<int32_t*>(ptr); }
};

Buffer* BufOf(PJRT_Buffer* b) { return reinterpret_cast<Buffer*>(b); }

// A fresh buffer with its memory (peer memory with `peer`), or nullptr
// with *err set.
Buffer* NewBuffer(const Client* c, int d, PJRT_Buffer_Type t,
                  std::vector<int64_t> dims, std::string* err,
                  bool peer = false) {
  size_t n = ElemSize(t);
  for (int64_t x : dims) n *= size_t(x);
  auto* b = new Buffer(c, d, t, std::move(dims), n);
  *err = peer ? c->backend->AllocPeer(d, n, &b->ptr)
              : c->backend->Alloc(d, n, &b->ptr);
  if (!err->empty()) {
    delete b;
    return nullptr;
  }
  return b;
}

PJRT_Error* BufferFromHostBuffer(PJRT_Client_BufferFromHostBuffer_Args* a) {
  auto* c = reinterpret_cast<Client*>(a->client);
  const int d = c->IndexOf(a->device);
  if (d < 0) return Err("BufferFromHostBuffer needs a device of this client");
  if (a->memory != nullptr || a->device_layout != nullptr) {
    return Err("memory spaces and device layouts are not supported");
  }
  const size_t elem = ElemSize(a->type);
  if (elem == 0) return Err("unsupported element type " +
                            std::to_string(a->type));
  std::vector<int64_t> dims(a->dims, a->dims + a->num_dims);
  for (int64_t x : dims) {
    if (x < 0) return Err("negative dimension in " + Shape(a->type, dims));
  }
  if (a->num_byte_strides != 0) {
    // Only the dense row-major layout, which unset strides also mean.
    int64_t stride = int64_t(elem);
    for (size_t i = dims.size(); i-- > 0;) {
      if (a->byte_strides[i] != stride && dims[i] > 1) {
        return Err("only dense row-major host buffers are supported");
      }
      stride *= dims[i];
    }
  }
  std::string err;
  Buffer* b = NewBuffer(c, d, a->type, std::move(dims), &err);
  if (b == nullptr) return Internal(err);
  PJRT_Event* done = nullptr;
  if (b->bytes == 0) {
    done = ReadyEvent();
  } else {
    err = c->backend->CopyIn(d, b->ptr, a->data, b->bytes);
    // Ready once the copy has read the host memory to its end.
    if (err.empty()) done = c->EventAfter(d, &err);
  }
  if (done == nullptr) {
    delete b;
    return Internal(err);
  }
  a->buffer = reinterpret_cast<PJRT_Buffer*>(b);
  a->done_with_host_buffer = done;
  return nullptr;
}
PJRT_Error* BufferDestroy(PJRT_Buffer_Destroy_Args* a) {
  delete BufOf(a->buffer);
  return nullptr;
}
PJRT_Error* BufferOnDeviceSize(PJRT_Buffer_OnDeviceSizeInBytes_Args* a) {
  a->on_device_size_in_bytes = BufOf(a->buffer)->bytes;
  return nullptr;
}
PJRT_Error* BufferDimensions(PJRT_Buffer_Dimensions_Args* a) {
  Buffer* b = BufOf(a->buffer);
  a->dims = b->dims.data();
  a->num_dims = b->dims.size();
  return nullptr;
}
PJRT_Error* BufferElementType(PJRT_Buffer_ElementType_Args* a) {
  a->type = BufOf(a->buffer)->type;
  return nullptr;
}
PJRT_Error* BufferGetMemoryLayout(PJRT_Buffer_GetMemoryLayout_Args* a) {
  Buffer* b = BufOf(a->buffer);
  memset(&a->layout, 0, sizeof(a->layout));
  a->layout.struct_size = PJRT_Buffer_MemoryLayout_STRUCT_SIZE;
  a->layout.type = PJRT_Buffer_MemoryLayout_Type_Tiled;
  a->layout.tiled.struct_size = PJRT_Buffer_MemoryLayout_Tiled_STRUCT_SIZE;
  a->layout.tiled.minor_to_major = b->minor_to_major.data();
  a->layout.tiled.minor_to_major_size = b->minor_to_major.size();
  return nullptr;
}
PJRT_Error* BufferToHostBuffer(PJRT_Buffer_ToHostBuffer_Args* a) {
  Buffer* b = BufOf(a->src);
  if (a->host_layout != nullptr) return Err("host layouts are not supported");
  if (a->dst == nullptr) {
    a->dst_size = b->bytes;
    return nullptr;
  }
  if (a->dst_size < b->bytes) {
    return Err("ToHostBuffer: dst holds " + std::to_string(a->dst_size) +
               " bytes, the buffer " + std::to_string(b->bytes));
  }
  if (b->bytes == 0) {
    a->event = ReadyEvent();
    return nullptr;
  }
  const Client* c = b->owner;
  std::string err = b->backend->CopyOut(b->device, a->dst, b->ptr, b->bytes);
  if (err.empty()) {
    a->event = const_cast<Client*>(c)->EventAfter(b->device, &err);
  }
  return err.empty() ? nullptr : Internal(err);
}

// ---- compile: the brt_mlir_module programs, by module name ----

struct Executable {
  Program program;
  std::string name;
  int replicas = 1;
  int64_t n = 0;  // vector length (add, reduce, collectives)
  int rows = 0, dim = 0, k = 0;  // gather_rows, scatter_sub
};

struct LoadedExecutable {
  Client* client;
  Executable exe;
};

// "name" of `module @name `, or "".
std::string ModuleName(const std::string& text) {
  size_t p = text.find("module @");
  if (p == std::string::npos) return "";
  p += 8;
  size_t e = p;
  while (e < text.size() && (isalnum(static_cast<unsigned char>(text[e])) ||
                             text[e] == '_')) {
    ++e;
  }
  return text.substr(p, e - p);
}

bool ParseInt(const std::string& s, int64_t* out) {
  if (s.empty() || s.size() > 18) return false;
  for (char ch : s) {
    if (ch < '0' || ch > '9') return false;
  }
  *out = strtoll(s.c_str(), nullptr, 10);
  return true;
}

// The type of `%arg<i>: tensor<AxBx...xT>`: its dims and element type.
bool ArgType(const std::string& text, int i, std::vector<int64_t>* dims,
             std::string* elem) {
  const std::string anchor = "%arg" + std::to_string(i) + ": tensor<";
  size_t p = text.find(anchor);
  if (p == std::string::npos) return false;
  p += anchor.size();
  const size_t e = text.find('>', p);
  if (e == std::string::npos) return false;
  const std::string body = text.substr(p, e - p);
  dims->clear();
  size_t s = 0;
  for (;;) {
    const size_t x = body.find('x', s);
    if (x == std::string::npos) break;
    int64_t v;
    if (!ParseInt(body.substr(s, x - s), &v)) return false;
    dims->push_back(v);
    s = x + 1;
  }
  *elem = body.substr(s);
  return true;
}

struct ArgSpec {
  PJRT_Buffer_Type type;
  std::vector<int64_t> dims;
};

// What Execute takes for each argument of one replica.
std::vector<ArgSpec> ArgSpecs(const Executable& e) {
  const auto f32 = PJRT_Buffer_Type_F32, s32 = PJRT_Buffer_Type_S32;
  switch (e.program) {
    case Program::kAdd: return {{f32, {e.n}}, {f32, {e.n}}};
    case Program::kReduceSum:
    case Program::kAllReduce:
    case Program::kAllGather: return {{f32, {e.n}}};
    case Program::kGatherRows: return {{f32, {e.rows, e.dim}}, {s32, {e.k}}};
    case Program::kScatterSub:
      return {{f32, {e.rows, e.dim}}, {s32, {e.k}}, {f32, {e.k, e.dim}},
              {f32, {}}};
  }
  return {};
}

PJRT_Error* ParseModule(const std::string& text, const Backend& backend,
                        Executable* e) {
  e->name = ModuleName(text);
  static const std::pair<const char*, Program> kModules[] = {
      {"brt_add", Program::kAdd},
      {"brt_reduce_sum", Program::kReduceSum},
      {"brt_all_reduce", Program::kAllReduce},
      {"brt_all_gather", Program::kAllGather},
      {"brt_gather_rows", Program::kGatherRows},
      {"brt_scatter_sub", Program::kScatterSub}};
  bool known = false;
  for (const auto& [name, program] : kModules) {
    if (e->name == name) {
      e->program = program;
      known = true;
    }
  }
  if (!known) {
    return Err("unrecognized module @" + (e->name.empty() ? "?" : e->name) +
                   ": this plugin runs only the six brt_mlir_module "
                   "programs",
               PJRT_Error_Code_UNIMPLEMENTED);
  }
  const std::string what = "module @" + e->name;
  const size_t r = text.find("mhlo.num_replicas = ");
  int64_t replicas = 1;
  if (r != std::string::npos) {
    size_t s = r + 20, t = s;
    while (t < text.size() && isdigit(static_cast<unsigned char>(text[t]))) {
      ++t;
    }
    if (!ParseInt(text.substr(s, t - s), &replicas)) {
      return Err(what + ": bad mhlo.num_replicas");
    }
  }
  const bool collective = e->program == Program::kAllReduce ||
                          e->program == Program::kAllGather;
  if (replicas < 1 || (!collective && replicas != 1)) {
    return Err(what + ": " + std::to_string(replicas) +
               " replicas; it runs on one");
  }
  if (replicas > backend.max_replicas()) {
    return Err(what + ": " + std::to_string(replicas) +
               " replicas; the kernels take at most " +
               std::to_string(backend.max_replicas()));
  }
  if (replicas > backend.device_count()) {
    return Err(what + ": " + std::to_string(replicas) +
               " replicas; the client has " +
               std::to_string(backend.device_count()) + " devices");
  }
  e->replicas = int(replicas);
  std::vector<int64_t> a0, a1;
  std::string t0, t1;
  if (!ArgType(text, 0, &a0, &t0)) return Err(what + ": no %arg0 type");
  if (e->program == Program::kGatherRows ||
      e->program == Program::kScatterSub) {
    if (a0.size() != 2 || t0 != "f32" || !ArgType(text, 1, &a1, &t1) ||
        a1.size() != 1 || t1 != "i32") {
      return Err(what + ": want tensor<RxDxf32> and tensor<Kxi32>");
    }
    if (a0[0] > INT_MAX || a0[1] > INT_MAX || a1[0] > INT_MAX) {
      return Err(what + ": rows, dim and k must each fit an int for the "
                        "kernels");
    }
    e->rows = int(a0[0]);
    e->dim = int(a0[1]);
    e->k = int(a1[0]);
  } else {
    if (a0.size() != 1 || t0 != "f32") {
      return Err(what + ": want tensor<Nxf32>");
    }
    e->n = a0[0];
  }
  // Every argument's type is what the builder writes, and there is no more.
  const std::vector<ArgSpec> specs = ArgSpecs(*e);
  for (size_t i = 0; i <= specs.size(); ++i) {
    std::vector<int64_t> dims;
    std::string elem;
    const bool present = ArgType(text, int(i), &dims, &elem);
    if (i == specs.size()) {
      if (present || text.find("%arg" + std::to_string(i) + ":") !=
                         std::string::npos) {
        return Err(what + ": more than " + std::to_string(specs.size()) +
                   " arguments");
      }
      break;
    }
    const std::string want =
        specs[i].type == PJRT_Buffer_Type_F32 ? "f32" : "i32";
    if (!present || dims != specs[i].dims || elem != want) {
      return Err(what + ": argument " + std::to_string(i) + " is not " +
                 Shape(specs[i].type, specs[i].dims));
    }
  }
  return nullptr;
}

PJRT_Error* ClientCompile(PJRT_Client_Compile_Args* a) {
  auto* c = reinterpret_cast<Client*>(a->client);
  if (std::string(a->program->format, a->program->format_size) != "mlir") {
    return Err("only mlir programs");
  }
  const std::string text(a->program->code, a->program->code_size);
  Executable exe;
  if (PJRT_Error* err = ParseModule(text, *c->backend, &exe)) return err;
  if (exe.replicas > 1) {
    std::string err = c->backend->EnablePeers(exe.replicas);
    if (!err.empty()) return Err("module @" + exe.name + ": " + err,
                                 PJRT_Error_Code_FAILED_PRECONDITION);
  }
  a->executable = reinterpret_cast<PJRT_LoadedExecutable*>(
      new LoadedExecutable{c, exe});
  return nullptr;
}

PJRT_Error* LoadedGetExecutable(PJRT_LoadedExecutable_GetExecutable_Args* a) {
  auto* le = reinterpret_cast<LoadedExecutable*>(a->loaded_executable);
  a->executable = reinterpret_cast<PJRT_Executable*>(new Executable(le->exe));
  return nullptr;
}
PJRT_Error* ExecutableDestroy(PJRT_Executable_Destroy_Args* a) {
  delete reinterpret_cast<Executable*>(a->executable);
  return nullptr;
}
PJRT_Error* LoadedDestroy(PJRT_LoadedExecutable_Destroy_Args* a) {
  delete reinterpret_cast<LoadedExecutable*>(a->executable);
  return nullptr;
}
PJRT_Error* ExecutableNumOutputs(PJRT_Executable_NumOutputs_Args* a) {
  a->num_outputs = 1;
  return nullptr;
}

// ---- execute ----

void Count(Program p) {
  g_launches[int(p)].fetch_add(1, std::memory_order_relaxed);
}

// Launches a one-replica program on device `dev`; *out is its output.
std::string RunSingle(Client* c, const Executable& e, int dev,
                      PJRT_Buffer* const* args, Buffer** out) {
  Backend& be = *c->backend;
  std::vector<int64_t> dims;
  switch (e.program) {
    case Program::kAdd: dims = {e.n}; break;
    case Program::kReduceSum: dims = {}; break;
    case Program::kGatherRows: dims = {e.k, e.dim}; break;
    case Program::kScatterSub: dims = {e.rows, e.dim}; break;
    default: return "not a one-replica program";
  }
  std::string err;
  Buffer* o = NewBuffer(c, dev, PJRT_Buffer_Type_F32, dims, &err);
  if (o == nullptr) return err;
  const Buffer* x = BufOf(args[0]);
  bool launched = false;
  switch (e.program) {
    case Program::kAdd:
      if (e.n > 0) {
        err = be.Add(dev, x->f32(), BufOf(args[1])->f32(), o->f32(), e.n);
        launched = true;
      }
      break;
    case Program::kReduceSum:  // n == 0 writes +0.0f
      err = be.ReduceSum(dev, x->f32(), o->f32(), e.n);
      launched = true;
      break;
    case Program::kGatherRows:
      if (e.k > 0 && e.dim > 0) {
        err = be.GatherRows(dev, x->f32(), BufOf(args[1])->i32(), o->f32(),
                            e.k, e.rows, e.dim);
        launched = true;
      }
      break;
    case Program::kScatterSub:  // k == 0 copies the table
      if (e.rows > 0 && e.dim > 0) {
        err = be.ScatterSub(dev, x->f32(), BufOf(args[1])->i32(),
                            BufOf(args[2])->f32(), BufOf(args[3])->f32(),
                            o->f32(), e.k, e.rows, e.dim);
        launched = true;
      }
      break;
    default: break;
  }
  if (!err.empty()) {
    delete o;
    return err;
  }
  if (launched) Count(e.program);
  *out = o;
  return "";
}

// The collectives over R replicas, ordered as the port's _collective:
// every output is allocated on its replica's stream, then a ready marker
// is recorded on every replica's stream (after the allocations, which are
// themselves operations on those streams), then each replica's stream
// waits for every other replica's ready marker and launches; then the
// join: each stream waits for every replica's launch. So a peer reads an
// input, and writes into an output's block, only after the work its
// owner had issued before the call, and nothing issued to a replica later
// (a fetch of its output, a free of its input) overtakes a peer's access.
// Where the replicas span cards, what the peers touch is peer memory: the
// outputs are made there and an all-reduce's inputs (which the peers read)
// are copied there before the ready markers; the copies are freed after
// the join.
std::string RunCollective(Client* c, const Executable& e,
                          PJRT_Buffer* const* const* args,
                          std::vector<Buffer*>* outs) {
  Backend& be = *c->backend;
  const int R = e.replicas;
  const int64_t n = e.n;
  const bool gather = e.program == Program::kAllGather;
  const bool peer = be.SpansCards(R);
  std::string err;
  for (int d = 0; d < R && err.empty(); ++d) {
    Buffer* o = NewBuffer(c, d, PJRT_Buffer_Type_F32,
                          {gather ? n * R : n}, &err, peer);
    if (o != nullptr) outs->push_back(o);
  }
  std::vector<const float*> ins(static_cast<size_t>(R));
  std::vector<std::unique_ptr<Buffer>> copies;
  for (int d = 0; d < R && err.empty(); ++d) {
    ins[size_t(d)] = BufOf(args[d][0])->f32();
    if (!peer || gather || n == 0) continue;
    copies.emplace_back(NewBuffer(c, d, PJRT_Buffer_Type_F32, {n}, &err,
                                  true));
    if (!err.empty()) break;
    err = be.CopyWithin(d, copies.back()->ptr, ins[size_t(d)],
                        size_t(n) * sizeof(float));
    ins[size_t(d)] = copies.back()->f32();
  }
  std::vector<Marker> ready(size_t(R), nullptr), done(size_t(R), nullptr);
  auto destroy = [&be](std::vector<Marker>& ms) {
    for (Marker& m : ms) {
      if (m != nullptr) be.Destroy(m);
      m = nullptr;
    }
  };
  for (int d = 0; d < R && err.empty() && R > 1; ++d) {
    err = be.Record(d, &ready[size_t(d)]);
  }
  std::vector<float*> out_ptrs(static_cast<size_t>(R));
  for (int d = 0; d < R && err.empty(); ++d) {
    out_ptrs[size_t(d)] = (*outs)[size_t(d)]->f32();
  }
  const bool two_shot = R > 1 && !gather && be.TwoShot(R, n);
  for (int d = 0; d < R && err.empty(); ++d) {
    for (int o = 0; o < R && err.empty() && R > 1; ++o) {
      if (o != d) err = be.StreamWait(d, ready[size_t(o)]);
    }
    if (!err.empty()) break;
    if (gather) {
      if (n > 0) {
        err = be.AllGather(d, ins[size_t(d)], out_ptrs.data(), R, d * n, n);
        if (err.empty()) Count(e.program);
      }
      continue;
    }
    int64_t begin = 0, end = n;
    if (two_shot) AllReduceSlice(n, R, d, &begin, &end);
    if (end > begin) {
      float* const* targets =
          two_shot ? out_ptrs.data() : &out_ptrs[size_t(d)];
      err = be.AllReduce(d, ins.data(), R, targets, two_shot ? R : 1, begin,
                         end);
      if (err.empty()) Count(e.program);
    }
  }
  for (int d = 0; d < R && err.empty() && R > 1; ++d) {
    err = be.Record(d, &done[size_t(d)]);
  }
  for (int d = 0; d < R && err.empty() && R > 1; ++d) {
    for (int o = 0; o < R && err.empty(); ++o) {
      if (o != d) err = be.StreamWait(d, done[size_t(o)]);
    }
  }
  destroy(ready);
  destroy(done);
  if (!err.empty()) {
    for (Buffer* o : *outs) delete o;
    outs->clear();
  }
  return err;
}

PJRT_Error* LoadedExecute(PJRT_LoadedExecutable_Execute_Args* a) {
  auto* le = reinterpret_cast<LoadedExecutable*>(a->executable);
  Client* c = le->client;
  const Executable& e = le->exe;
  const std::string what = "module @" + e.name;
  if (a->execute_device != nullptr) {
    return Err(what + ": execute_device is not supported");
  }
  if (a->num_devices != size_t(e.replicas)) {
    return Err(what + " is compiled for " + std::to_string(e.replicas) +
               " replicas; Execute got num_devices " +
               std::to_string(a->num_devices));
  }
  const std::vector<ArgSpec> specs = ArgSpecs(e);
  if (a->num_args != specs.size()) {
    return Err(what + " takes " + std::to_string(specs.size()) +
               " arguments a replica; Execute got " +
               std::to_string(a->num_args));
  }
  if (a->output_lists == nullptr) return Err(what + ": no output lists");
  // Replica d runs on device d, but a one-replica program runs on the
  // device its arguments lie on: the core launches replica 0 and sets no
  // execute_device, and a shard's table may live on any device.
  std::vector<int> devices;
  for (int d = 0; d < e.replicas; ++d) devices.push_back(d);
  if (e.replicas == 1 && a->argument_lists[0][0] != nullptr) {
    devices[0] = BufOf(a->argument_lists[0][0])->device;
  }
  for (int d = 0; d < e.replicas; ++d) {
    for (size_t i = 0; i < specs.size(); ++i) {
      const Buffer* b = a->argument_lists[d][i] == nullptr
                            ? nullptr
                            : BufOf(a->argument_lists[d][i]);
      const std::string arg = what + ": argument " + std::to_string(i) +
                              " of replica " + std::to_string(d);
      if (b == nullptr || b->owner != c) {
        return Err(arg + " is not a buffer of this client");
      }
      if (b->device != devices[size_t(d)]) {
        return Err(arg + " lies on device " + std::to_string(b->device) +
                   ", not on device " + std::to_string(devices[size_t(d)]));
      }
      if (b->type != specs[i].type || b->dims != specs[i].dims) {
        return Err(arg + " is " + Shape(b->type, b->dims) + "; the module "
                   "takes " + Shape(specs[i].type, specs[i].dims));
      }
    }
  }
  std::vector<Buffer*> outs;
  std::string err;
  if (e.program == Program::kAllReduce || e.program == Program::kAllGather) {
    err = RunCollective(c, e, a->argument_lists, &outs);
  } else {
    Buffer* o = nullptr;
    err = RunSingle(c, e, devices[0], a->argument_lists[0], &o);
    if (o != nullptr) outs.push_back(o);
  }
  if (!err.empty()) return Internal(what + ": " + err);
  std::vector<PJRT_Event*> events;
  if (a->device_complete_events != nullptr) {
    for (int d = 0; d < e.replicas && err.empty(); ++d) {
      PJRT_Event* ev = c->EventAfter(devices[size_t(d)], &err);
      if (ev != nullptr) events.push_back(ev);
    }
  }
  if (!err.empty()) {
    // Fired or not, the events are ours to drop; the outputs are freed in
    // stream order after the work that writes them.
    for (PJRT_Event* ev : events) delete reinterpret_cast<Event*>(ev);
    for (Buffer* o : outs) delete o;
    return Internal(what + ": " + err);
  }
  for (int d = 0; d < e.replicas; ++d) {
    a->output_lists[d][0] = reinterpret_cast<PJRT_Buffer*>(outs[size_t(d)]);
    if (a->device_complete_events != nullptr) {
      a->device_complete_events[d] = events[size_t(d)];
    }
  }
  return nullptr;
}

PJRT_Api MakeApi() {
  PJRT_Api api;
  memset(&api, 0, sizeof(api));
  api.struct_size = PJRT_Api_STRUCT_SIZE;
  api.pjrt_api_version.struct_size = PJRT_Api_Version_STRUCT_SIZE;
  api.pjrt_api_version.major_version = PJRT_API_MAJOR;
  api.pjrt_api_version.minor_version = PJRT_API_MINOR;
  api.PJRT_Error_Destroy = ErrorDestroy;
  api.PJRT_Error_Message = ErrorMessage;
  api.PJRT_Error_GetCode = ErrorGetCode;
  api.PJRT_Plugin_Initialize = PluginInitialize;
  api.PJRT_Plugin_Attributes = PluginAttributes;
  api.PJRT_Event_Destroy = EventDestroy;
  api.PJRT_Event_IsReady = EventIsReady;
  api.PJRT_Event_Error = EventError;
  api.PJRT_Event_Await = EventAwait;
  api.PJRT_Event_OnReady = EventOnReady;
  api.PJRT_Client_Create = ClientCreate;
  api.PJRT_Client_Destroy = ClientDestroy;
  api.PJRT_Client_PlatformName = ClientPlatformName;
  api.PJRT_Client_AddressableDevices = ClientAddressableDevices;
  api.PJRT_Client_BufferFromHostBuffer = BufferFromHostBuffer;
  api.PJRT_Client_Compile = ClientCompile;
  api.PJRT_Buffer_Destroy = BufferDestroy;
  api.PJRT_Buffer_OnDeviceSizeInBytes = BufferOnDeviceSize;
  api.PJRT_Buffer_Dimensions = BufferDimensions;
  api.PJRT_Buffer_ElementType = BufferElementType;
  api.PJRT_Buffer_GetMemoryLayout = BufferGetMemoryLayout;
  api.PJRT_Buffer_ToHostBuffer = BufferToHostBuffer;
  api.PJRT_LoadedExecutable_Destroy = LoadedDestroy;
  api.PJRT_LoadedExecutable_GetExecutable = LoadedGetExecutable;
  api.PJRT_LoadedExecutable_Execute = LoadedExecute;
  api.PJRT_Executable_Destroy = ExecutableDestroy;
  api.PJRT_Executable_NumOutputs = ExecutableNumOutputs;
  return api;
}

}  // namespace
}  // namespace brt_pjrt

extern "C" const PJRT_Api* GetPjrtApi() {
  static PJRT_Api api = brt_pjrt::MakeApi();
  return &api;
}

extern "C" long long brt_pjrt_launches(int program) {
  if (program < 0 || program >= brt_pjrt::kPrograms) return -1;
  return brt_pjrt::g_launches[program].load(std::memory_order_relaxed);
}

extern "C" const char* brt_pjrt_program_name(int program) {
  if (program < 0 || program >= brt_pjrt::kPrograms) return nullptr;
  return brt_pjrt::ProgramName(brt_pjrt::Program(program));
}

extern "C" long long brt_pjrt_live_buffers() {
  return brt_pjrt::g_live_buffers.load(std::memory_order_relaxed);
}
