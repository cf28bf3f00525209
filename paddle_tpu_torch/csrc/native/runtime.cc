// The native runtime shared by ptpu_predict and ptpu_train (runtime.h).

#include "runtime.h"

#include <ATen/Context.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <ATen/core/stack.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/scalar_tensor.h>
#include <caffe2/serialize/inline_container.h>

#include <arpa/inet.h>
#include <endian.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cmath>
#include <cstring>
#include <fstream>
#include <limits>
#include <optional>
#include <sstream>
#include <stdexcept>

#ifndef PTPU_SCHEMA_MAJOR
#error "build with -DPTPU_SCHEMA_MAJOR / -DPTPU_SCHEMA_MINOR (native.py)"
#endif

namespace ptpu {

void Die(const std::string& msg) { throw std::runtime_error(msg); }

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// -- JSON -------------------------------------------------------------------

const Json& Json::At(const std::string& k) const {
  auto it = obj.find(k);
  if (it == obj.end()) Die("missing JSON key '" + k + "'");
  return it->second;
}

int64_t Json::Int() const {
  if (kind != kNum) Die("JSON value is not a number");
  return is_int ? inum : static_cast<int64_t>(num);
}

namespace {

class JsonParser {
 public:
  explicit JsonParser(const std::string& s) : s_(s) {}
  Json Parse() {
    Json v = Value();
    Ws();
    if (p_ != s_.size()) Die("trailing JSON content");
    return v;
  }

 private:
  void Ws() {
    while (p_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[p_])))
      ++p_;
  }
  char Peek() {
    Ws();
    if (p_ >= s_.size()) Die("unexpected end of JSON");
    return s_[p_];
  }
  void Expect(char c) {
    if (Peek() != c) Die(std::string("expected '") + c + "' in JSON");
    ++p_;
  }
  bool Lit(const char* lit) {
    size_t n = std::strlen(lit);
    if (s_.compare(p_, n, lit) != 0) return false;
    p_ += n;
    return true;
  }
  Json Value() {
    char c = Peek();
    if (c == '{') return Object();
    if (c == '[') return Array();
    if (c == '"') {
      Json v;
      v.kind = Json::kStr;
      v.str = String();
      return v;
    }
    Json v;
    if (Lit("true")) {
      v.kind = Json::kBool;
      v.b = true;
      return v;
    }
    if (Lit("false")) {
      v.kind = Json::kBool;
      return v;
    }
    if (Lit("null")) return v;
    // Python's json writes these for non-finite floats
    v.kind = Json::kNum;
    if (Lit("NaN")) {
      v.num = std::numeric_limits<double>::quiet_NaN();
      return v;
    }
    if (Lit("Infinity")) {
      v.num = std::numeric_limits<double>::infinity();
      return v;
    }
    if (Lit("-Infinity")) {
      v.num = -std::numeric_limits<double>::infinity();
      return v;
    }
    return Number();
  }
  Json Number() {
    size_t start = p_;
    bool is_int = true;
    while (p_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[p_])) ||
            std::strchr("+-.eE", s_[p_]))) {
      if (std::strchr(".eE", s_[p_])) is_int = false;
      ++p_;
    }
    if (p_ == start) Die("bad JSON value");
    Json v;
    v.kind = Json::kNum;
    std::string tok = s_.substr(start, p_ - start);
    v.num = std::stod(tok);
    v.is_int = is_int;
    if (is_int) v.inum = std::stoll(tok);
    return v;
  }
  std::string String() {
    Expect('"');
    std::string out;
    while (p_ < s_.size() && s_[p_] != '"') {
      char c = s_[p_++];
      if (c != '\\') {
        out += c;
        continue;
      }
      if (p_ >= s_.size()) Die("bad JSON escape");
      char e = s_[p_++];
      switch (e) {
        case 'n': out += '\n'; break;
        case 't': out += '\t'; break;
        case 'r': out += '\r'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'u': {
          if (p_ + 4 > s_.size()) Die("bad \\u escape");
          unsigned code = std::stoul(s_.substr(p_, 4), nullptr, 16);
          p_ += 4;
          if (code < 0x80) {
            out += static_cast<char>(code);
          } else if (code < 0x800) {
            out += static_cast<char>(0xC0 | (code >> 6));
            out += static_cast<char>(0x80 | (code & 0x3F));
          } else {
            out += static_cast<char>(0xE0 | (code >> 12));
            out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
            out += static_cast<char>(0x80 | (code & 0x3F));
          }
          break;
        }
        default: out += e;
      }
    }
    Expect('"');
    return out;
  }
  Json Array() {
    Expect('[');
    Json v;
    v.kind = Json::kArr;
    if (Peek() == ']') {
      ++p_;
      return v;
    }
    while (true) {
      v.arr.push_back(Value());
      if (Peek() == ',') {
        ++p_;
        continue;
      }
      Expect(']');
      return v;
    }
  }
  Json Object() {
    Expect('{');
    Json v;
    v.kind = Json::kObj;
    if (Peek() == '}') {
      ++p_;
      return v;
    }
    while (true) {
      std::string key = String();
      Expect(':');
      v.obj[key] = Value();
      if (Peek() == ',') {
        ++p_;
        continue;
      }
      Expect('}');
      return v;
    }
  }

  const std::string& s_;
  size_t p_ = 0;
};

}  // namespace

Json ParseJson(const std::string& text) { return JsonParser(text).Parse(); }

std::string JsonQuote(const std::string& s) {
  std::string out = "\"";
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default: out += c;
    }
  }
  return out + "\"";
}

// -- dtypes and .npy ----------------------------------------------------------

namespace {

const std::vector<std::pair<std::string, at::ScalarType>>& DtypeTable() {
  static const std::vector<std::pair<std::string, at::ScalarType>> t = {
      {"float32", at::kFloat}, {"float64", at::kDouble},
      {"float16", at::kHalf},  {"bfloat16", at::kBFloat16},
      {"int64", at::kLong},    {"int32", at::kInt},
      {"int16", at::kShort},   {"int8", at::kChar},
      {"uint8", at::kByte},    {"bool", at::kBool}};
  return t;
}

}  // namespace

at::ScalarType DtypeByName(const std::string& name) {
  for (const auto& [n, t] : DtypeTable())
    if (n == name) return t;
  Die("unsupported dtype " + name);
}

std::string DtypeName(at::ScalarType t) {
  for (const auto& [n, s] : DtypeTable())
    if (s == t) return n;
  Die(std::string("unsupported dtype ") + c10::toString(t));
}

std::string NpyDescr(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return "<f4";
    case at::kDouble: return "<f8";
    case at::kHalf: return "<f2";
    case at::kBFloat16: return "<u2";
    case at::kLong: return "<i8";
    case at::kInt: return "<i4";
    case at::kShort: return "<i2";
    case at::kChar: return "|i1";
    case at::kByte: return "|u1";
    case at::kBool: return "|b1";
    default: Die(std::string("no .npy type for ") + c10::toString(t));
  }
}

Npy ReadNpy(const std::string& path) {
  std::string raw = ReadFile(path);
  if (raw.size() < 10 || raw.compare(0, 6, "\x93NUMPY") != 0)
    Die(path + " is not a .npy file");
  int major = static_cast<unsigned char>(raw[6]);
  size_t hlen = 0, hoff;
  if (major == 1) {
    hlen = static_cast<unsigned char>(raw[8]) |
           (static_cast<unsigned char>(raw[9]) << 8);
    hoff = 10;
  } else {
    for (int i = 0; i < 4; ++i)
      hlen |= static_cast<size_t>(static_cast<unsigned char>(raw[8 + i]))
              << (8 * i);
    hoff = 12;
  }
  std::string header = raw.substr(hoff, hlen);
  Npy out;
  size_t d = header.find("'descr':");
  size_t q1 = header.find('\'', d + 8);
  size_t q2 = header.find('\'', q1 + 1);
  out.descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (header.find("'fortran_order': False") == std::string::npos)
    Die(path + ": fortran_order arrays are not supported");
  size_t sh = header.find("'shape':");
  size_t p1 = header.find('(', sh);
  size_t p2 = header.find(')', p1);
  std::stringstream ss(header.substr(p1 + 1, p2 - p1 - 1));
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    if (tok.find_first_not_of(" \t") == std::string::npos) continue;
    out.shape.push_back(std::stoll(tok));
  }
  out.data = raw.substr(hoff + hlen);
  return out;
}

at::Tensor NpyToTensor(const Npy& npy, at::ScalarType dtype,
                       const std::string& what) {
  if (npy.descr != NpyDescr(dtype))
    Die(what + ": dtype " + npy.descr + " but model expects " +
        DtypeName(dtype) + " (" + NpyDescr(dtype) + ")");
  at::Tensor t = at::empty(npy.shape, at::TensorOptions().dtype(dtype));
  if (static_cast<size_t>(t.nbytes()) != npy.data.size())
    Die(what + ": " + std::to_string(npy.data.size()) +
        " data bytes for shape of " + std::to_string(t.nbytes()));
  std::memcpy(t.data_ptr(), npy.data.data(), npy.data.size());
  return t;
}

at::Tensor HostOutput(const at::Tensor& t) {
  at::Tensor h = t.to(at::kCPU).contiguous();
  return h.scalar_type() == at::kBFloat16 ? h.to(at::kFloat) : h;
}

void WriteNpy(const std::string& path, const at::Tensor& t) {
  at::Tensor h = t.to(at::kCPU).contiguous();
  std::ostringstream hd;
  hd << "{'descr': '" << NpyDescr(h.scalar_type())
     << "', 'fortran_order': False, 'shape': (";
  for (int64_t d : h.sizes()) hd << d << ",";
  hd << "), }";
  std::string header = hd.str();
  size_t total = 10 + header.size() + 1;
  header += std::string((64 - total % 64) % 64, ' ');
  header += '\n';
  std::ofstream f(path, std::ios::binary);
  if (!f) Die("cannot write " + path);
  f << "\x93NUMPY" << '\x01' << '\x00';
  uint16_t hlen = static_cast<uint16_t>(header.size());
  f.write(reinterpret_cast<const char*>(&hlen), 2);
  f << header;
  f.write(static_cast<const char*>(h.data_ptr()), h.nbytes());
}

// -- meta -------------------------------------------------------------------

Meta ReadMeta(const std::string& path) {
  std::ifstream f(path);
  if (!f) Die("cannot open " + path);
  Meta m;
  std::string line;
  while (std::getline(f, line)) {
    std::stringstream ss(line);
    std::string key;
    ss >> key;
    if (key == "version") {
      ss >> m.version;
    } else if (key == "in" || key == "out") {
      TensorSpec t;
      ss >> t.name >> t.dtype;
      int64_t d;
      while (ss >> d) t.dims.push_back(d);
      (key == "in" ? m.ins : m.outs).push_back(t);
    } else if (key == "nfetch") {
      ss >> m.nfetch;
    } else if (key == "carry") {
      int o, i;
      ss >> o >> i;
      m.carry[o] = i;
    } else if (key == "init") {
      int i;
      std::string file;
      ss >> i >> file;
      m.init[i] = file;
    } else if (key == "archive") {
      std::string dev, file;
      ss >> dev >> file;
      m.archives[dev] = file;
    } else if (key == "tf32") {
      ss >> m.tf32_matmul >> m.tf32_cudnn;
    }
  }
  if (m.outs.empty()) Die("no outputs in " + path);
  if (m.archives.empty()) Die("no archive named in " + path);
  return m;
}

void CheckFeed(const TensorSpec& spec, const std::string& dtype,
               const std::vector<int64_t>& shape) {
  if (dtype != spec.dtype)
    Die("feed '" + spec.name + "': dtype " + dtype + " but model expects " +
        spec.dtype);
  if (shape.size() != spec.dims.size())
    Die("feed '" + spec.name + "': rank " + std::to_string(shape.size()) +
        " but model expects " + std::to_string(spec.dims.size()));
  for (size_t i = 0; i < shape.size(); ++i)
    if (spec.dims[i] >= 0 && shape[i] != spec.dims[i])
      Die("feed '" + spec.name + "': dim " + std::to_string(i) + " is " +
          std::to_string(shape[i]) + " but model expects " +
          std::to_string(spec.dims[i]));
}

void ApplyTf32(const Meta& meta) {
  at::globalContext().setAllowTF32CuBLAS(meta.tf32_matmul != 0);
  at::globalContext().setAllowTF32CuDNN(meta.tf32_cudnn != 0);
}

c10::Device PickDevice(const std::string& flag, const Meta& meta) {
  std::string kind = flag.empty() ? (BuiltWithCuda() ? "cuda" : "cpu") : flag;
  if (kind != "cpu" && kind != "cuda")
    Die("--device must be cpu or cuda, not " + kind);
  if (kind == "cuda" && !BuiltWithCuda())
    Die("--device cuda: this build has no CUDA kernels (built without a "
        "card); it never runs a CUDA archive on the CPU");
  if (kind == "cuda" && !at::hasCUDA())
    Die("--device cuda: no CUDA device is visible");
  if (!meta.archives.count(kind))
    Die("the export holds no " + kind + " archive (a torch.export graph "
        "fixes its device)");
  return kind == "cpu" ? c10::Device(c10::kCPU) : c10::Device(c10::kCUDA, 0);
}

std::string KnownSchemaVersion() {
  return std::to_string(PTPU_SCHEMA_MAJOR) + "." +
         std::to_string(PTPU_SCHEMA_MINOR);
}

// -- the graph runner -------------------------------------------------------

namespace {

// torch._export.serde.schema's enums -> c10's
at::ScalarType SerdeScalarType(int64_t v) {
  switch (v) {
    case 1: return at::kByte;
    case 2: return at::kChar;
    case 3: return at::kShort;
    case 4: return at::kInt;
    case 5: return at::kLong;
    case 6: return at::kHalf;
    case 7: return at::kFloat;
    case 8: return at::kDouble;
    case 9: return at::kComplexHalf;
    case 10: return at::kComplexFloat;
    case 11: return at::kComplexDouble;
    case 12: return at::kBool;
    case 13: return at::kBFloat16;
    case 28: return at::kUInt16;
    case 29: return at::kFloat8_e4m3fn;
    case 30: return at::kFloat8_e5m2;
    case 31: return at::kFloat8_e4m3fnuz;
    case 32: return at::kFloat8_e5m2fnuz;
    default: Die("unknown serialized scalar type " + std::to_string(v));
  }
}

c10::Layout SerdeLayout(int64_t v) {
  switch (v) {
    case 1: return c10::kSparse;
    case 2: return c10::kSparseCsr;
    case 3: return c10::kSparseCsc;
    case 4: return c10::kSparseBsr;
    case 5: return c10::kSparseBsc;
    case 6: return c10::kMkldnn;
    case 7: return c10::kStrided;
    default: Die("unknown serialized layout " + std::to_string(v));
  }
}

c10::MemoryFormat SerdeMemoryFormat(int64_t v) {
  switch (v) {
    case 1: return c10::MemoryFormat::Contiguous;
    case 2: return c10::MemoryFormat::ChannelsLast;
    case 3: return c10::MemoryFormat::ChannelsLast3d;
    case 4: return c10::MemoryFormat::Preserve;
    default: Die("unknown serialized memory format " + std::to_string(v));
  }
}

c10::Device SerdeDevice(const Json& d) {
  std::string type = d.At("type").str;
  const Json& idx = d.At("index");
  if (type == "cpu") return c10::Device(c10::kCPU);
  if (type == "cuda")
    return c10::Device(c10::kCUDA, idx.kind == Json::kNull
                                       ? 0
                                       : static_cast<int8_t>(idx.Int()));
  Die("unsupported device type " + type);
}

// What a list argument holds, to build the typed c10::List it needs.
enum class ListKind { kNone, kInts, kFloats, kBools, kTensors, kOptTensors,
                      kStrings };

}  // namespace

// One argument of a node, resolved when the archive is loaded: a constant,
// a value slot, or a list whose elements are constants or slots.
struct ArgPlan {
  enum Kind { kConst, kSlot, kList } kind = kConst;
  bool wants_tensor = false;  // the schema declares a Tensor: a Python
                              // number there is a wrapped-number tensor
  c10::IValue value;
  int slot = -1;
  ListKind list = ListKind::kNone;
  std::vector<int> slots;           // per element: slot, or -1 (constant)
  std::vector<c10::IValue> elems;   // per element: the constant
};

struct OutPlan {
  std::vector<int> slots;  // one for a single value, n for a list; -1 drops
  bool list = false;
};

struct Node {
  enum Kind { kOp, kSym, kCond, kWhile } kind = kOp;
  std::string target;
  std::string fn;  // kSym: the operation
  std::optional<c10::OperatorHandle> op;
  std::vector<ArgPlan> args;
  std::vector<OutPlan> outs;
  std::vector<std::unique_ptr<Graph>> graphs;  // cond: true, false;
                                               // while: cond, body
  std::vector<int> release;  // slots whose last use is this node
};

struct Graph {
  std::map<std::string, int> names;
  int n_slots = 0;
  std::vector<int> inputs;  // slot per graph input (-1: unused)
  std::vector<ArgPlan> outputs;
  std::vector<Node> nodes;

  int Slot(const std::string& name) {
    auto it = names.find(name);
    if (it != names.end()) return it->second;
    names[name] = n_slots;
    return n_slots++;
  }
};

namespace {

using Frame = std::vector<c10::IValue>;

ArgPlan Const(c10::IValue v) {
  ArgPlan a;
  a.value = std::move(v);
  return a;
}

ArgPlan SlotArg(int slot) {
  ArgPlan a;
  a.kind = ArgPlan::kSlot;
  a.slot = slot;
  return a;
}

// A {"as_name": n} / {"as_int" | "as_float" | "as_bool": v} symbolic value.
ArgPlan SymArg(Graph& g, const Json& j) {
  if (j.Has("as_name")) return SlotArg(g.Slot(j.At("as_name").str));
  if (j.Has("as_int")) return Const(j.At("as_int").Int());
  if (j.Has("as_float")) return Const(j.At("as_float").num);
  if (j.Has("as_bool")) return Const(j.At("as_bool").b);
  Die("bad symbolic value in the graph");
}

ArgPlan ListArg(ListKind kind) {
  ArgPlan a;
  a.kind = ArgPlan::kList;
  a.list = kind;
  return a;
}

void AddElem(ArgPlan& a, const ArgPlan& e) {
  a.slots.push_back(e.kind == ArgPlan::kSlot ? e.slot : -1);
  a.elems.push_back(e.kind == ArgPlan::kSlot ? c10::IValue() : e.value);
}

// One serialized Argument (torch._export.serde.schema.Argument) as a plan.
// Graph arguments (as_graph) are the caller's.
ArgPlan BuildArg(Graph& g, const Json& arg) {
  if (arg.obj.size() != 1) Die("malformed argument in the graph");
  const std::string& k = arg.obj.begin()->first;
  const Json& v = arg.obj.begin()->second;
  if (k == "as_none") return Const(c10::IValue());
  if (k == "as_tensor") return SlotArg(g.Slot(v.At("name").str));
  if (k == "as_optional_tensor") {
    if (v.Has("as_tensor")) return SlotArg(g.Slot(v.At("as_tensor").At("name").str));
    return Const(c10::IValue());
  }
  if (k == "as_int") return Const(v.Int());
  if (k == "as_float") return Const(v.num);
  if (k == "as_bool") return Const(v.b);
  if (k == "as_string") return Const(v.str);
  if (k == "as_sym_int" || k == "as_sym_float" || k == "as_sym_bool")
    return SymArg(g, v);
  if (k == "as_scalar_type")
    return Const(static_cast<int64_t>(SerdeScalarType(v.Int())));
  if (k == "as_layout") return Const(static_cast<int64_t>(SerdeLayout(v.Int())));
  if (k == "as_memory_format")
    return Const(static_cast<int64_t>(SerdeMemoryFormat(v.Int())));
  if (k == "as_device") return Const(SerdeDevice(v));
  ArgPlan a;
  if (k == "as_ints" || k == "as_sym_ints") {
    a = ListArg(ListKind::kInts);
    for (const auto& e : v.arr)
      AddElem(a, k == "as_ints" ? Const(e.Int()) : SymArg(g, e));
  } else if (k == "as_floats" || k == "as_sym_floats") {
    a = ListArg(ListKind::kFloats);
    for (const auto& e : v.arr)
      AddElem(a, k == "as_floats" ? Const(e.num) : SymArg(g, e));
  } else if (k == "as_bools" || k == "as_sym_bools") {
    a = ListArg(ListKind::kBools);
    for (const auto& e : v.arr)
      AddElem(a, k == "as_bools" ? Const(e.b) : SymArg(g, e));
  } else if (k == "as_strings") {
    a = ListArg(ListKind::kStrings);
    for (const auto& e : v.arr) AddElem(a, Const(e.str));
  } else if (k == "as_tensors") {
    a = ListArg(ListKind::kTensors);
    for (const auto& e : v.arr) AddElem(a, SlotArg(g.Slot(e.At("name").str)));
  } else if (k == "as_optional_tensors") {
    a = ListArg(ListKind::kOptTensors);
    for (const auto& e : v.arr)
      AddElem(a, e.Has("as_tensor")
                     ? SlotArg(g.Slot(e.At("as_tensor").At("name").str))
                     : Const(c10::IValue()));
  } else {
    Die("unsupported argument kind '" + k + "' in the graph");
  }
  return a;
}

// The list kind an (empty or constant) list argument must take for a
// schema argument of type `t`.
ListKind ListKindOf(const c10::TypePtr& t) {
  c10::TypePtr u = t;
  if (auto opt = u->cast<c10::OptionalType>()) u = opt->getElementType();
  auto lt = u->cast<c10::ListType>();
  if (!lt) return ListKind::kNone;
  c10::TypePtr e = lt->getElementType();
  if (auto opt = e->cast<c10::OptionalType>()) {
    if (opt->getElementType()->kind() == c10::TypeKind::TensorType)
      return ListKind::kOptTensors;
    e = opt->getElementType();
  }
  switch (e->kind()) {
    case c10::TypeKind::IntType:
    case c10::TypeKind::SymIntType: return ListKind::kInts;
    case c10::TypeKind::FloatType:
    case c10::TypeKind::SymFloatType: return ListKind::kFloats;
    case c10::TypeKind::BoolType:
    case c10::TypeKind::SymBoolType: return ListKind::kBools;
    case c10::TypeKind::TensorType: return ListKind::kTensors;
    case c10::TypeKind::StringType: return ListKind::kStrings;
    default: return ListKind::kNone;
  }
}

bool IsFloatType(const c10::TypePtr& t) {
  c10::TypePtr u = t;
  if (auto opt = u->cast<c10::OptionalType>()) u = opt->getElementType();
  return u->kind() == c10::TypeKind::FloatType ||
         u->kind() == c10::TypeKind::SymFloatType;
}

// Fit a plan to its schema argument: an int where a float is declared, a
// list whose element type only the schema tells (an empty one).
void Coerce(ArgPlan& a, const c10::Argument& arg) {
  a.wants_tensor = arg.type()->kind() == c10::TypeKind::TensorType;
  if (a.kind == ArgPlan::kConst && a.value.isInt() && IsFloatType(arg.type()))
    a.value = static_cast<double>(a.value.toInt());
  if (a.kind == ArgPlan::kList) {
    ListKind want = ListKindOf(arg.type());
    if (want != ListKind::kNone &&
        (a.slots.empty() || want == ListKind::kFloats ||
         want == ListKind::kOptTensors))
      a.list = want;
    if (want == ListKind::kFloats)
      for (auto& e : a.elems)
        if (e.isInt()) e = static_cast<double>(e.toInt());
  }
}

// A number where the schema declares a Tensor, as Python's argument
// parser passes it: a 0-dim wrapped-number tensor (type promotion treats
// it as a scalar).
c10::IValue WrapNumber(const c10::IValue& v) {
  if (v.isTensor() || v.isNone()) return v;
  at::Tensor t = at::scalar_tensor(v.toScalar(),
                                   at::TensorOptions().dtype(
                                       v.isBool() ? at::kBool
                                       : v.isInt() ? at::kLong
                                                   : at::kDouble));
  t.unsafeGetTensorImpl()->set_wrapped_number(true);
  return t;
}

c10::IValue Eval(const ArgPlan& a, const Frame& f) {
  if (a.kind == ArgPlan::kConst)
    return a.wants_tensor ? WrapNumber(a.value) : a.value;
  if (a.kind == ArgPlan::kSlot)
    return a.wants_tensor ? WrapNumber(f[a.slot]) : f[a.slot];
  auto elem = [&](size_t i) -> const c10::IValue& {
    return a.slots[i] >= 0 ? f[a.slots[i]] : a.elems[i];
  };
  size_t n = a.slots.size();
  switch (a.list) {
    case ListKind::kInts: {
      c10::List<int64_t> l;
      l.reserve(n);
      for (size_t i = 0; i < n; ++i) {
        const c10::IValue& e = elem(i);
        l.push_back(e.isInt() ? e.toInt() : e.toSymInt().expect_int());
      }
      return l;
    }
    case ListKind::kFloats: {
      c10::List<double> l;
      for (size_t i = 0; i < n; ++i) {
        const c10::IValue& e = elem(i);
        l.push_back(e.isInt() ? static_cast<double>(e.toInt()) : e.toDouble());
      }
      return l;
    }
    case ListKind::kBools: {
      c10::List<bool> l;
      for (size_t i = 0; i < n; ++i) l.push_back(elem(i).toBool());
      return l;
    }
    case ListKind::kTensors: {
      c10::List<at::Tensor> l;
      l.reserve(n);
      for (size_t i = 0; i < n; ++i) l.push_back(elem(i).toTensor());
      return l;
    }
    case ListKind::kOptTensors: {
      c10::List<std::optional<at::Tensor>> l;
      for (size_t i = 0; i < n; ++i) {
        const c10::IValue& e = elem(i);
        l.push_back(e.isNone() ? std::optional<at::Tensor>()
                               : std::optional<at::Tensor>(e.toTensor()));
      }
      return l;
    }
    case ListKind::kStrings: {
      c10::List<std::string> l;
      for (size_t i = 0; i < n; ++i) l.push_back(elem(i).toStringRef());
      return l;
    }
    default: Die("list argument of unknown type");
  }
}

std::vector<c10::IValue> EvalList(const ArgPlan& a, const Frame& f) {
  std::vector<c10::IValue> out;
  for (size_t i = 0; i < a.slots.size(); ++i)
    out.push_back(a.slots[i] >= 0 ? f[a.slots[i]] : a.elems[i]);
  return out;
}

OutPlan BuildOut(Graph& g, const Json& out) {
  OutPlan o;
  const std::string& k = out.obj.begin()->first;
  const Json& v = out.obj.begin()->second;
  if (k == "as_tensor") {
    o.slots.push_back(g.Slot(v.At("name").str));
  } else if (k == "as_tensors") {
    o.list = true;
    for (const auto& e : v.arr) o.slots.push_back(g.Slot(e.At("name").str));
  } else if (k == "as_sym_int" || k == "as_sym_float" || k == "as_sym_bool") {
    o.slots.push_back(v.Has("as_name") ? g.Slot(v.At("as_name").str) : -1);
  } else if (k == "as_optional_tensors") {
    o.list = true;
    for (const auto& e : v.arr)
      o.slots.push_back(e.Has("as_tensor")
                            ? g.Slot(e.At("as_tensor").At("name").str)
                            : -1);
  } else {
    o.slots.push_back(-1);  // as_none, or a constant the graph never reads
  }
  return o;
}

void Store(const OutPlan& o, c10::IValue v, Frame& f) {
  if (!o.list) {
    if (o.slots[0] >= 0) f[o.slots[0]] = std::move(v);
    return;
  }
  auto l = v.toList();
  for (size_t i = 0; i < o.slots.size(); ++i)
    if (o.slots[i] >= 0) f[o.slots[i]] = l.get(i);
}

std::unique_ptr<Graph> BuildGraph(const Json& g);

// Python's floor division and modulo on integers.
int64_t FloorDiv(int64_t a, int64_t b) {
  if (b == 0) Die("integer division by zero in a symbolic expression");
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

c10::IValue SymOp(const std::string& fn, const std::vector<c10::IValue>& a) {
  auto num = [](const c10::IValue& v) {
    return v.isInt() ? static_cast<double>(v.toInt())
                     : v.isBool() ? static_cast<double>(v.toBool())
                                  : v.toDouble();
  };
  auto ints = [&]() {
    for (const auto& v : a)
      if (!v.isInt() && !v.isBool()) return false;
    return true;
  };
  auto i = [](const c10::IValue& v) {
    return v.isBool() ? static_cast<int64_t>(v.toBool()) : v.toInt();
  };
  if (a.size() == 1) {
    const c10::IValue& x = a[0];
    if (fn == "neg") return x.isInt() ? c10::IValue(-x.toInt()) : c10::IValue(-num(x));
    if (fn == "not_" || fn == "sym_not") return c10::IValue(!(num(x) != 0));
    if (fn == "sym_float") return c10::IValue(num(x));
    if (fn == "sym_int" || fn == "trunc")
      return c10::IValue(static_cast<int64_t>(std::trunc(num(x))));
    if (fn == "ceil") return c10::IValue(static_cast<int64_t>(std::ceil(num(x))));
    if (fn == "floor")
      return c10::IValue(static_cast<int64_t>(std::floor(num(x))));
    if (fn == "sym_sqrt" || fn == "_sym_sqrt") return c10::IValue(std::sqrt(num(x)));
    if (fn == "abs") return x.isInt() ? c10::IValue(static_cast<int64_t>(std::llabs(x.toInt())))
                                      : c10::IValue(std::fabs(num(x)));
  }
  if (a.size() == 3 && fn == "sym_ite") return num(a[0]) != 0 ? a[1] : a[2];
  if (a.size() == 2) {
    bool in = ints();
    if (fn == "add") return in ? c10::IValue(i(a[0]) + i(a[1])) : c10::IValue(num(a[0]) + num(a[1]));
    if (fn == "sub") return in ? c10::IValue(i(a[0]) - i(a[1])) : c10::IValue(num(a[0]) - num(a[1]));
    if (fn == "mul") return in ? c10::IValue(i(a[0]) * i(a[1])) : c10::IValue(num(a[0]) * num(a[1]));
    if (fn == "truediv") return c10::IValue(num(a[0]) / num(a[1]));
    if (fn == "floordiv")
      return in ? c10::IValue(FloorDiv(i(a[0]), i(a[1])))
                : c10::IValue(std::floor(num(a[0]) / num(a[1])));
    if (fn == "mod") {
      if (!in) {
        double r = std::fmod(num(a[0]), num(a[1]));
        if (r != 0 && ((r < 0) != (num(a[1]) < 0))) r += num(a[1]);
        return c10::IValue(r);
      }
      return c10::IValue(i(a[0]) - FloorDiv(i(a[0]), i(a[1])) * i(a[1]));
    }
    if (fn == "pow") {
      if (in && i(a[1]) >= 0) {
        int64_t r = 1;
        for (int64_t k = 0; k < i(a[1]); ++k) r *= i(a[0]);
        return c10::IValue(r);
      }
      return c10::IValue(std::pow(num(a[0]), num(a[1])));
    }
    if (fn == "sym_max" || fn == "max")
      return in ? c10::IValue(std::max(i(a[0]), i(a[1])))
                : c10::IValue(std::max(num(a[0]), num(a[1])));
    if (fn == "sym_min" || fn == "min")
      return in ? c10::IValue(std::min(i(a[0]), i(a[1])))
                : c10::IValue(std::min(num(a[0]), num(a[1])));
    if (fn == "eq") return c10::IValue(num(a[0]) == num(a[1]));
    if (fn == "ne") return c10::IValue(num(a[0]) != num(a[1]));
    if (fn == "lt") return c10::IValue(num(a[0]) < num(a[1]));
    if (fn == "le") return c10::IValue(num(a[0]) <= num(a[1]));
    if (fn == "gt") return c10::IValue(num(a[0]) > num(a[1]));
    if (fn == "ge") return c10::IValue(num(a[0]) >= num(a[1]));
    if (fn == "and_") return c10::IValue(num(a[0]) != 0 && num(a[1]) != 0);
    if (fn == "or_") return c10::IValue(num(a[0]) != 0 || num(a[1]) != 0);
  }
  Die("unsupported symbolic operation " + fn + " of " +
      std::to_string(a.size()) + " operands");
}

bool StartsWith(const std::string& s, const char* p) {
  return s.compare(0, std::strlen(p), p) == 0;
}

// The op a "torch.ops.<ns>.<name>.<overload>" target names.
c10::OperatorHandle FindOp(const std::string& target) {
  std::string rest = target.substr(std::strlen("torch.ops."));
  size_t a = rest.find('.');
  size_t b = rest.rfind('.');
  if (a == std::string::npos || a == b) Die("bad op target " + target);
  std::string name = rest.substr(0, a) + "::" + rest.substr(a + 1, b - a - 1);
  std::string overload = rest.substr(b + 1);
  if (overload == "default") overload = "";
  return c10::Dispatcher::singleton().findSchemaOrThrow(name.c_str(),
                                                        overload.c_str());
}

Node BuildNode(Graph& g, const Json& n) {
  Node node;
  node.target = n.At("target").str;
  const auto& inputs = n.At("inputs").arr;
  for (const auto& o : n.At("outputs").arr) node.outs.push_back(BuildOut(g, o));
  const std::string& t = node.target;
  if (t == "torch.ops.higher_order.cond" ||
      t == "torch.ops.higher_order.while_loop") {
    node.kind = t == "torch.ops.higher_order.cond" ? Node::kCond : Node::kWhile;
    for (const auto& in : inputs) {
      const Json& arg = in.At("arg");
      if (arg.Has("as_graph"))
        node.graphs.push_back(BuildGraph(arg.At("as_graph").At("graph")));
      else
        node.args.push_back(BuildArg(g, arg));
    }
    if (node.graphs.size() != 2) Die(t + ": expected two subgraphs");
    return node;
  }
  static const char* kSymPrefixes[] = {"_operator.", "operator.", "torch.sym_",
                                       "torch._sym_", "math.", "builtins."};
  for (const char* p : kSymPrefixes) {
    if (StartsWith(t, p)) {
      node.kind = Node::kSym;
      node.fn = t.substr(std::strlen(p));
      if (StartsWith(t, "torch.")) node.fn = t.substr(std::strlen("torch."));
      for (const auto& in : inputs) node.args.push_back(BuildArg(g, in.At("arg")));
      return node;
    }
  }
  if (!StartsWith(t, "torch.ops.")) Die("unsupported graph target " + t);
  node.kind = Node::kOp;
  node.op = FindOp(t);
  const c10::FunctionSchema& schema = node.op->schema();
  const auto& sargs = schema.arguments();
  std::vector<std::optional<ArgPlan>> plans(sargs.size());
  size_t positional = 0;
  for (const auto& in : inputs) {
    const std::string& name = in.At("name").str;
    std::optional<size_t> idx;
    if (name.empty()) {
      idx = positional;
    } else if (auto j = schema.argumentIndexWithName(name)) {
      idx = static_cast<size_t>(*j);
    }
    if (!idx || *idx >= sargs.size())
      Die(t + ": no argument '" + name + "' in " + c10::toString(schema));
    plans[*idx] = BuildArg(g, in.At("arg"));
    ++positional;
  }
  for (size_t i = 0; i < sargs.size(); ++i) {
    if (!plans[i]) {
      if (!sargs[i].default_value())
        Die(t + ": argument '" + sargs[i].name() + "' missing");
      plans[i] = Const(*sargs[i].default_value());
    }
    Coerce(*plans[i], sargs[i]);
    node.args.push_back(std::move(*plans[i]));
  }
  return node;
}

void CollectSlots(const ArgPlan& a, std::vector<int>* out) {
  if (a.kind == ArgPlan::kSlot) out->push_back(a.slot);
  for (int s : a.slots)
    if (s >= 0) out->push_back(s);
}

std::unique_ptr<Graph> BuildGraph(const Json& gj) {
  auto g = std::make_unique<Graph>();
  for (const auto& in : gj.At("inputs").arr) {
    const std::string& k = in.obj.begin()->first;
    const Json& v = in.obj.begin()->second;
    if (k == "as_tensor")
      g->inputs.push_back(g->Slot(v.At("name").str));
    else if ((k == "as_sym_int" || k == "as_sym_bool" || k == "as_sym_float") &&
             v.Has("as_name"))
      g->inputs.push_back(g->Slot(v.At("as_name").str));
    else
      g->inputs.push_back(-1);
  }
  for (const auto& n : gj.At("nodes").arr) g->nodes.push_back(BuildNode(*g, n));
  for (const auto& o : gj.At("outputs").arr) g->outputs.push_back(BuildArg(*g, o));
  // release each value after its last use: a frame keeps nothing the rest
  // of the graph does not read (as the Python module's generated code)
  std::vector<int> last(g->n_slots, -1);
  std::vector<bool> keep(g->n_slots, false);
  for (size_t i = 0; i < g->nodes.size(); ++i) {
    std::vector<int> used;
    for (const auto& a : g->nodes[i].args) CollectSlots(a, &used);
    for (const auto& o : g->nodes[i].outs)
      for (int s : o.slots)
        if (s >= 0) used.push_back(s);
    for (int s : used) last[s] = static_cast<int>(i);
  }
  for (const auto& a : g->outputs) {
    std::vector<int> used;
    CollectSlots(a, &used);
    for (int s : used) keep[s] = true;
  }
  for (int s = 0; s < g->n_slots; ++s)
    if (!keep[s] && last[s] >= 0) g->nodes[last[s]].release.push_back(s);
  return g;
}

std::vector<c10::IValue> CallGraph(const Graph& g,
                                   const std::vector<c10::IValue>& inputs);

bool Truth(const c10::IValue& v) {
  if (v.isTensor()) return v.toTensor().item<bool>();
  if (v.isBool()) return v.toBool();
  if (v.isInt()) return v.toInt() != 0;
  return v.toDouble() != 0;
}

void RunNode(const Node& node, Frame& f) {
  switch (node.kind) {
    case Node::kOp: {
      torch::jit::Stack st;
      st.reserve(node.args.size());
      for (const auto& a : node.args) st.push_back(Eval(a, f));
      node.op->callBoxed(&st);
      if (node.outs.size() == st.size()) {
        for (size_t i = 0; i < st.size(); ++i)
          Store(node.outs[i], std::move(st[i]), f);
      } else if (node.outs.size() == 1 && !st.empty()) {
        Store(node.outs[0], std::move(st[0]), f);
      } else if (!node.outs.empty()) {
        Die(node.target + ": " + std::to_string(st.size()) +
            " results for " + std::to_string(node.outs.size()) + " outputs");
      }
      break;
    }
    case Node::kSym: {
      std::vector<c10::IValue> a;
      for (const auto& p : node.args) a.push_back(Eval(p, f));
      Store(node.outs[0], SymOp(node.fn, a), f);
      break;
    }
    case Node::kCond: {
      bool pred = Truth(Eval(node.args[0], f));
      std::vector<c10::IValue> ops = EvalList(node.args[1], f);
      auto res = CallGraph(*node.graphs[pred ? 0 : 1], ops);
      for (size_t i = 0; i < node.outs.size() && i < res.size(); ++i)
        Store(node.outs[i], res[i], f);
      break;
    }
    case Node::kWhile: {
      std::vector<c10::IValue> carry = EvalList(node.args[0], f);
      std::vector<c10::IValue> extra =
          node.args.size() > 1 ? EvalList(node.args[1], f)
                               : std::vector<c10::IValue>();
      while (true) {
        std::vector<c10::IValue> in = carry;
        in.insert(in.end(), extra.begin(), extra.end());
        if (!Truth(CallGraph(*node.graphs[0], in).at(0))) break;
        carry = CallGraph(*node.graphs[1], in);
        carry.resize(node.args[0].slots.size());
      }
      for (size_t i = 0; i < node.outs.size() && i < carry.size(); ++i)
        Store(node.outs[i], carry[i], f);
      break;
    }
  }
  for (int s : node.release) f[s] = c10::IValue();
}

std::vector<c10::IValue> CallGraph(const Graph& g,
                                   const std::vector<c10::IValue>& inputs) {
  if (inputs.size() != g.inputs.size())
    Die("graph called with " + std::to_string(inputs.size()) +
        " inputs for " + std::to_string(g.inputs.size()));
  Frame f(g.n_slots);
  for (size_t i = 0; i < inputs.size(); ++i)
    if (g.inputs[i] >= 0) f[g.inputs[i]] = inputs[i];
  for (const auto& n : g.nodes) {
    try {
      RunNode(n, f);
    } catch (const c10::Error& e) {
      Die("node " + n.target + ": " + e.what_without_backtrace());
    } catch (const std::exception& e) {
      std::string msg = e.what();
      if (msg.compare(0, 5, "node ") == 0) throw;
      Die("node " + n.target + ": " + msg.substr(0, 2000));
    }
  }
  std::vector<c10::IValue> out;
  for (const auto& a : g.outputs) out.push_back(Eval(a, f));
  return out;
}

std::string ReadRecord(caffe2::serialize::PyTorchStreamReader& r,
                       const std::string& name) {
  auto [ptr, size] = r.getRecord(name);
  return std::string(static_cast<const char*>(ptr.get()), size);
}

// model weights or constants: fqn -> tensor on `device`, aliasing kept
std::map<std::string, at::Tensor> LoadPayload(
    caffe2::serialize::PyTorchStreamReader& r, const std::string& dir,
    const std::string& config_name, c10::Device device) {
  std::map<std::string, at::Tensor> out;
  if (!r.hasRecord(config_name)) return out;
  Json cfg = ParseJson(ReadRecord(r, config_name));
  std::map<std::string, at::Tensor> files;
  for (const auto& [fqn, p] : cfg.At("config").obj) {
    if (p.Has("use_pickle") && p.At("use_pickle").b)
      Die(fqn + ": pickled payloads are not supported");
    const Json& tm = p.At("tensor_meta");
    at::ScalarType dtype = SerdeScalarType(tm.At("dtype").Int());
    std::vector<int64_t> sizes, strides;
    for (const auto& s : tm.At("sizes").arr) sizes.push_back(s.At("as_int").Int());
    for (const auto& s : tm.At("strides").arr)
      strides.push_back(s.At("as_int").Int());
    int64_t offset = tm.At("storage_offset").At("as_int").Int();
    const std::string& path = p.At("path_name").str;
    auto it = files.find(path);
    if (it == files.end()) {
      std::string rec = dir + path;
      size_t nbytes = r.getRecordSize(rec);
      at::Tensor flat;
      if (nbytes == 0) {
        flat = at::empty(sizes, at::TensorOptions().dtype(dtype)).zero_();
      } else {
        int64_t numel = static_cast<int64_t>(nbytes / c10::elementSize(dtype));
        flat = at::empty({numel}, at::TensorOptions().dtype(dtype));
        r.getRecord(rec, flat.data_ptr(), nbytes);
      }
      it = files.emplace(path, flat.to(device)).first;
    }
    at::Tensor base = it->second;
    out[fqn] = base.numel() == 0 && !sizes.empty()
                   ? base.reshape(sizes)
                   : base.as_strided(sizes, strides, offset);
  }
  return out;
}

}  // namespace

Program::Program(const std::string& path, c10::Device device)
    : device_(device) {
  caffe2::serialize::PyTorchStreamReader r(path);
  std::string model;
  for (const auto& rec : r.getAllRecords()) {
    if (StartsWith(rec, "models/") && rec.size() > 12 &&
        rec.compare(rec.size() - 5, 5, ".json") == 0)
      model = rec.substr(7, rec.size() - 12);
  }
  if (model.empty()) Die(path + ": no models/<name>.json in the archive");
  Json root = ParseJson(ReadRecord(r, "models/" + model + ".json"));
  const Json& sv = root.At("schema_version");
  int64_t major = sv.At("major").Int(), minor = sv.At("minor").Int();
  if (major != PTPU_SCHEMA_MAJOR || minor > PTPU_SCHEMA_MINOR)
    Die(path + ": archive schema_version " + std::to_string(major) + "." +
        std::to_string(minor) + " is not one this runner reads (" +
        KnownSchemaVersion() + ")");
  const Json& gm = root.At("graph_module");
  graph_ = BuildGraph(gm.At("graph"));
  auto weights = LoadPayload(r, "data/weights/",
                             "data/weights/" + model + "_weights_config.json",
                             device);
  auto consts = LoadPayload(
      r, "data/constants/",
      "data/constants/" + model + "_constants_config.json", device);
  auto find = [&](const std::map<std::string, at::Tensor>& m,
                  const std::string& k) {
    auto it = m.find(k);
    if (it == m.end()) Die(path + ": no payload for " + k);
    return it->second;
  };
  const auto& specs = gm.At("signature").At("input_specs").arr;
  if (specs.size() != graph_->inputs.size())
    Die(path + ": signature and graph disagree on the inputs");
  fixed_inputs_.resize(specs.size());
  for (size_t i = 0; i < specs.size(); ++i) {
    const std::string& k = specs[i].obj.begin()->first;
    const Json& v = specs[i].obj.begin()->second;
    if (k == "user_input") {
      user_input_pos_.push_back(static_cast<int>(i));
    } else if (k == "parameter") {
      fixed_inputs_[i] = find(weights, v.At("parameter_name").str);
    } else if (k == "buffer") {
      const std::string& name = v.At("buffer_name").str;
      fixed_inputs_[i] = weights.count(name) ? weights[name]
                                             : find(consts, name);
    } else if (k == "tensor_constant") {
      fixed_inputs_[i] = find(consts, v.At("tensor_constant_name").str);
    } else if (k == "constant_input") {
      Graph scratch;
      fixed_inputs_[i] = BuildArg(scratch, v.At("value")).value;
    } else if (k != "token") {
      Die(path + ": unsupported input kind " + k);
    }
  }
  n_user_inputs_ = user_input_pos_.size();
  const auto& outs = gm.At("signature").At("output_specs").arr;
  for (size_t i = 0; i < outs.size(); ++i) {
    const std::string& k = outs[i].obj.begin()->first;
    if (k == "user_output" || k == "loss_output")
      user_output_pos_.push_back(static_cast<int>(i));
  }
}

Program::~Program() = default;

size_t Program::num_nodes() const { return graph_->nodes.size(); }

std::vector<at::Tensor> Program::Run(
    const std::vector<at::Tensor>& inputs) const {
  if (inputs.size() != n_user_inputs_)
    Die("expected " + std::to_string(n_user_inputs_) + " inputs, got " +
        std::to_string(inputs.size()));
  std::vector<c10::IValue> all = fixed_inputs_;
  for (size_t i = 0; i < inputs.size(); ++i) {
    if (inputs[i].device() != device_)
      Die("input " + std::to_string(i) + " is on " + inputs[i].device().str() +
          ", the archive on " + device_.str());
    all[user_input_pos_[i]] = inputs[i];
  }
  auto res = CallGraph(*graph_, all);
  std::vector<at::Tensor> out;
  for (int p : user_output_pos_) {
    const c10::IValue& v = res.at(p);
    if (!v.isTensor()) Die("a user output is not a tensor");
    out.push_back(v.toTensor());
  }
  return out;
}

// -- serving wire framing ---------------------------------------------------

namespace {

ssize_t RecvExact(int fd, char* buf, size_t n) {
  if (n == 0) return 1;
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, buf + got, n - got, 0);
    if (r <= 0) return r;
    got += static_cast<size_t>(r);
  }
  return static_cast<ssize_t>(got);
}

bool SendAll(int fd, const char* buf, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = ::send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

bool RecvRequest(int fd, Request* out) {
  char lenbuf[4];
  if (RecvExact(fd, lenbuf, 4) <= 0) return false;
  uint32_t hlen;
  std::memcpy(&hlen, lenbuf, 4);
  hlen = le32toh(hlen);  // payloads are little-endian, as this host
  if (hlen == 0) Die("malformed request: zero-length header");
  if (hlen > (64u << 20)) Die("unreasonable header length");
  std::string hraw(hlen, '\0');
  if (RecvExact(fd, hraw.data(), hlen) <= 0) return false;
  out->header = ParseJson(hraw);
  out->buffers.clear();
  if (!out->header.Has("feeds")) return true;
  for (const auto& spec : out->header.At("feeds").arr) {
    size_t n = c10::elementSize(DtypeByName(spec.At("dtype").str));
    for (const auto& d : spec.At("shape").arr) {
      // a negative or fractional dim would be undefined under the cast;
      // the bound inside the loop keeps the product within 64 bits
      if (!(d.num >= 0) || !(d.num <= 2147483648.0) ||
          d.num != static_cast<double>(static_cast<int64_t>(d.num)))
        Die("invalid tensor dim in feed shape");
      n *= static_cast<size_t>(d.num);
      if (n > (1u << 30)) Die("unreasonable tensor size");
    }
    std::string buf(n, '\0');
    if (n && RecvExact(fd, buf.data(), n) <= 0) return false;
    out->buffers.push_back(std::move(buf));
  }
  return true;
}

bool SendResponse(int fd, const std::string& header_json,
                  const std::vector<const at::Tensor*>& outs) {
  uint32_t hlen = htole32(static_cast<uint32_t>(header_json.size()));
  char lenbuf[4];
  std::memcpy(lenbuf, &hlen, 4);
  if (!SendAll(fd, lenbuf, 4)) return false;
  if (!SendAll(fd, header_json.data(), header_json.size())) return false;
  for (const auto* t : outs)
    if (!SendAll(fd, static_cast<const char*>(t->data_ptr()), t->nbytes()))
      return false;
  return true;
}

bool SendError(int fd, const std::string& msg) {
  return SendResponse(fd, "{\"error\": " + JsonQuote(msg) + "}", {});
}

}  // namespace ptpu
