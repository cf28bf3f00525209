// The native runtime shared by ptpu_predict and ptpu_train: a graph runner
// that interprets a torch.export archive (.pt2) through libtorch's
// dispatcher, plus the .npy files, the JAX package's meta line format, a
// minimal JSON parser and the serving wire framing.
//
// ≙ paddle_tpu/native/ptpu_predict.cc and ptpu_train.cc, which run
// StableHLO through TensorFlow's C API. Here the deployable unit is the
// archive that paddle_tpu_torch.io writes: the graph as JSON
// (models/model.json), the weights as raw storage bytes
// (data/weights/, described by model_weights_config.json). The runner
// reads both with caffe2::serialize::PyTorchStreamReader, resolves each
// node's target once with c10::Dispatcher::findSchemaOrThrow, and runs
// the nodes boxed, op by op, as the reference's C++ predictor interprets
// its ProgramDesc (api_impl.cc:126) and the port's executor its op plan.
// SymInt values (sym_size and the operator.* arithmetic on it) are plain
// integers at run time; torch.ops.higher_order.cond / while_loop run
// their subgraphs. The hand-written kernels appear as ptpu:: ops, which
// ptpu_ops.cc registers (with their CUDA implementations on the card).

#pragma once

#include <ATen/core/Tensor.h>
#include <ATen/core/ivalue.h>
#include <c10/core/Device.h>

#include <cstdint>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace ptpu {

[[noreturn]] void Die(const std::string& msg);

std::string ReadFile(const std::string& path);

// -- JSON -------------------------------------------------------------------

struct Json {
  enum Kind { kNull, kBool, kNum, kStr, kArr, kObj } kind = kNull;
  bool b = false;
  double num = 0;
  bool is_int = false;  // a number written without '.', 'e' or a literal
  int64_t inum = 0;
  std::string str;
  std::vector<Json> arr;
  std::map<std::string, Json> obj;

  bool Has(const std::string& k) const { return obj.count(k) != 0; }
  const Json& At(const std::string& k) const;
  int64_t Int() const;
};

Json ParseJson(const std::string& text);
std::string JsonQuote(const std::string& s);

// -- dtypes and .npy ----------------------------------------------------------

// "float32", "int64", "bfloat16", ... <-> at::ScalarType
at::ScalarType DtypeByName(const std::string& name);
std::string DtypeName(at::ScalarType t);
// The .npy descr a value of this type is written as (bfloat16: its uint16
// bit patterns, "<u2").
std::string NpyDescr(at::ScalarType t);

struct Npy {
  std::string descr;
  std::vector<int64_t> shape;
  std::string data;
};

Npy ReadNpy(const std::string& path);
void WriteNpy(const std::string& path, const at::Tensor& t);
// A CPU tensor of `dtype` holding the .npy's values; the descr must be the
// one `dtype` is stored as, else Die() names both.
at::Tensor NpyToTensor(const Npy& npy, at::ScalarType dtype,
                       const std::string& what);
// The bytes of a contiguous CPU copy of `t` (bfloat16 widened to float32).
at::Tensor HostOutput(const at::Tensor& t);

// -- meta files (io.export_inference_model / export_train_program) ---------

struct TensorSpec {
  std::string name;
  std::string dtype;
  std::vector<int64_t> dims;  // -1: symbolic
};

struct Meta {
  std::string version;
  std::vector<TensorSpec> ins, outs;
  int nfetch = 0;
  std::map<int, int> carry;           // out index -> in index
  std::map<int, std::string> init;    // in index -> .npy file
  std::map<std::string, std::string> archives;  // device type -> file
  int tf32_matmul = 0, tf32_cudnn = 0;
};

Meta ReadMeta(const std::string& path);
// Check a feed against its spec: dtype, rank and every fixed dim.
void CheckFeed(const TensorSpec& spec, const std::string& dtype,
               const std::vector<int64_t>& shape);
// Set cuBLAS's and cuDNN's TF32 use to what the exporting process had:
// libtorch's own cuDNN default (TF32 on) would differ from Python's run.
void ApplyTf32(const Meta& meta);
// The device the --device flag names; Die() if cuda is asked for and this
// build or machine has none, or the meta holds no archive for it.
c10::Device PickDevice(const std::string& flag, const Meta& meta);

// -- the graph runner -------------------------------------------------------

struct Graph;

class Program {
 public:
  // Load `path` (a .pt2 archive) with its weights on `device`. Refuses an
  // archive whose schema_version this build does not know.
  Program(const std::string& path, c10::Device device);
  ~Program();
  // Run the graph on the user inputs; returns the user outputs (mutations
  // of buffers or inputs are not applied). Safe to call from several
  // threads at once.
  std::vector<at::Tensor> Run(const std::vector<at::Tensor>& inputs) const;
  size_t num_nodes() const;
  size_t num_user_inputs() const { return n_user_inputs_; }

 private:
  std::unique_ptr<Graph> graph_;
  std::vector<c10::IValue> fixed_inputs_;  // weights / constants by input
  std::vector<int> user_input_pos_;        // graph input index per user input
  std::vector<int> user_output_pos_;       // graph output index per user out
  size_t n_user_inputs_ = 0;
  c10::Device device_;
};

// The schema_version (major.minor) this build reads.
std::string KnownSchemaVersion();

// -- kernels (ptpu_ops.cc) ------------------------------------------------

// {"flash_fwd": n, ...}: launches of each hand-written kernel in this
// process (all 0 in a build without the CUDA implementations).
std::string LaunchesJson();
// The ptpu:: schemas registered in this process, one per line.
std::string RegisteredSchemas();
bool BuiltWithCuda();
// Make one of the pool's CUDA streams current on this thread for the
// returned object's life (a serving connection's own stream, ≙ the
// reference's per-thread Clone, api_impl.cc:170); nothing on the CPU.
std::shared_ptr<void> UseOwnStream(c10::Device device);
// Wait for the device's work (timing); nothing on the CPU.
void Synchronize(c10::Device device);

// -- serving wire framing (serving/transport.py) ----------------------------

struct Request {
  Json header;
  std::vector<std::string> buffers;
};

// u32 little-endian header length, JSON header, raw tensor bytes for each
// feed in header order. Returns false when the peer closed cleanly.
bool RecvRequest(int fd, Request* out);
bool SendResponse(int fd, const std::string& header_json,
                  const std::vector<const at::Tensor*>& outs);
bool SendError(int fd, const std::string& msg);

}  // namespace ptpu
