// The port's PJRT plugin: the part of the PJRT C API that the native core's
// device layer calls (cpp/device/pjrt_device.cc, pjrt_executable.cc), over a
// backend that owns the memory and the programs.
//
// plugin.cc holds the PJRT surface and calls no CUDA: errors, the client
// and its devices, buffers, events, and the six programs that
// brt_mlir_module writes (add, reduce_sum, all_reduce, all_gather,
// gather_rows, scatter_sub), recognised by module name, checked at
// Compile against the kernels' limits and at Execute against their
// arguments. Two backends implement the interface below, each in a
// library of its own (brpc_tpu_torch/native_device.py builds them):
//
//  - cuda_backend.cu, the H100's: one CUDA stream a device, buffers from
//    cudaMallocAsync on it, the programs launched through the C entry
//    points of csrc/embedding_rows.cu and csrc/device_programs.cu;
//  - host_backend.cc, its plain version for tests on a CPU: one worker
//    thread a device runs that device's operations in order, the programs
//    as plain loops with the kernels' arithmetic.
//
// Devices. Replica d of a program runs on device d, except that a
// one-replica program runs on the device its arguments lie on (all of
// them on one): the core's PjrtExecutable launches replica 0 and names no
// device, and a PS shard's table may live on any device.
//
// Ordering. Everything issued to a device runs in issue order (its
// stream). A Marker is a point on a device's stream; a device can wait for
// another device's marker, and the host can wait for any marker. Every
// buffer is written, read and freed on its own device's stream, except by
// the collectives, whose replicas read the other replicas' inputs and
// write into their outputs; Execute orders those as
// brpc_tpu_torch/ops/device_programs.py's _collective does (plugin.cc).
//
// Completion. A PJRT event becomes ready when the marker behind it is
// passed. One completion thread a device of the client waits for that
// device's markers in issue order and runs the events' callbacks; it
// holds no lock of the plugin while it calls back, and an event that is
// ready already calls back at once, on the caller's thread.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace brt_pjrt {

enum class Program { kAdd, kReduceSum, kAllReduce, kAllGather, kGatherRows,
                     kScatterSub };
constexpr int kPrograms = 6;

// The kernels line's name of each program: "add", "reduce_sum",
// "all_reduce_sum", "all_gather", "gather_rows", "scatter_sub".
const char* ProgramName(Program p);

// A point on a device's stream; opaque to plugin.cc.
using Marker = void*;

// Every function returns "" on success, else what went wrong; launches
// and copies are issued on device d's stream and return before they run.
class Backend {
 public:
  virtual ~Backend() = default;

  virtual std::string platform() const = 0;
  virtual int device_count() const = 0;
  // The most replicas a collective program takes.
  virtual int max_replicas() const = 0;

  // Stream-ordered memory: *out is usable by work issued to d after this
  // call; Free releases it after the work issued to d before it. Zero
  // bytes give nullptr.
  virtual std::string Alloc(int d, size_t bytes, void** out) = 0;
  virtual void Free(int d, void* p) = 0;
  // host -> device and device -> host. The host side must stay valid until
  // a marker recorded after the copy is passed.
  virtual std::string CopyIn(int d, void* dst, const void* src,
                             size_t bytes) = 0;
  virtual std::string CopyOut(int d, void* dst, const void* src,
                              size_t bytes) = 0;

  virtual std::string Record(int d, Marker* out) = 0;
  // d's stream waits for m before what is issued to d next.
  virtual std::string StreamWait(int d, Marker m) = 0;
  // The calling thread waits until m is passed.
  virtual std::string Sync(Marker m) = 0;
  // May be called while waits on m are still pending.
  virtual void Destroy(Marker m) = 0;

  // Peer access between the devices' memories, for the collectives. An
  // error names a pair that has none.
  virtual std::string EnablePeers(int replicas) = 0;
  // The all-reduce's route: true for the two-shot.
  virtual bool TwoShot(int replicas, int64_t n) const = 0;

  // The programs, one launch on d's stream each; their semantics are
  // those of the C entry points (csrc/embedding_rows.cu,
  // csrc/device_programs.cu).
  virtual std::string Add(int d, const float* a, const float* b, float* out,
                          int64_t n) = 0;
  virtual std::string ReduceSum(int d, const float* x, float* out,
                                int64_t n) = 0;
  virtual std::string GatherRows(int d, const float* table,
                                 const int32_t* ids, float* out, int k,
                                 int rows, int dim) = 0;
  virtual std::string ScatterSub(int d, const float* table,
                                 const int32_t* ids, const float* grads,
                                 const float* lr, float* out, int k,
                                 int rows, int dim) = 0;
  // Sums [begin, end) of `replicas` inputs in replica order from +0.0f
  // into [begin, end) of each of `targets` outputs.
  virtual std::string AllReduce(int d, const float* const* inputs,
                                int replicas, float* const* outputs,
                                int targets, int64_t begin, int64_t end) = 0;
  // Stores `input` (n floats) at [offset, offset + n) of every output.
  virtual std::string AllGather(int d, const float* input,
                                float* const* outputs, int targets,
                                int64_t offset, int64_t n) = 0;
};

// Defined by each backend. num_devices < 0: the backend's default. Returns
// nullptr with *error set when the backend cannot offer the devices.
std::shared_ptr<Backend> MakeBackend(int num_devices, std::string* error);

// The two-shot all-reduce's slice of replica d: equal runs of whole
// kSliceFloats tiles, the rest in the last (the port's all_reduce_slices).
constexpr int64_t kSliceFloats = 1024;
void AllReduceSlice(int64_t n, int replicas, int d, int64_t* begin,
                    int64_t* end);

}  // namespace brt_pjrt

// Counters of the plugin, for drivers that report them (dlsym on the
// plugin's library): launches of each program since load, by its index
// in brt_pjrt::Program, and device buffers alive now.
extern "C" long long brt_pjrt_launches(int program);
extern "C" const char* brt_pjrt_program_name(int program);
extern "C" long long brt_pjrt_live_buffers();
