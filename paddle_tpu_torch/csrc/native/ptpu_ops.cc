// The six hand-written kernels as ptpu:: ops in a process without Python.
//
// The schemas come from paddle_tpu_torch/kernel_ops.py's SCHEMAS table,
// which native.py writes into ptpu_schemas.h at build time, so this
// process and the Python one register the same strings. Built with
// PTPU_WITH_CUDA (on a machine with the card), each op also gets a CUDA
// implementation that does what the Python one does (the kernel modules'
// `_*_launch`): check, allocate, launch through the kernel libraries'
// extern "C" entry points on the current stream, count the launch. An op
// has no other implementation: a CUDA archive on a build without them, or
// a ptpu:: op on a CPU tensor, raises.

#include <ATen/core/Tensor.h>
#include <torch/library.h>

#include <atomic>
#include <sstream>
#include <string>

#include "ptpu_schemas.h"  // generated: kPtpuSchemas[] = {"name(...)...", ...}
#include "runtime.h"

#ifdef PTPU_WITH_CUDA
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <map>
#include <mutex>
#include <tuple>
#endif

namespace {

const char* const kKernels[] = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                "decode_attention", "lstm_seq", "gru_seq"};
std::atomic<long> g_launches[6];

}  // namespace

TORCH_LIBRARY(ptpu, m) {
  for (const char* s : kPtpuSchemas) m.def(s);
}

namespace ptpu {

std::string LaunchesJson() {
  std::ostringstream os;
  os << "{";
  for (int i = 0; i < 6; ++i)
    os << (i ? ", " : "") << "\"" << kKernels[i] << "\": " << g_launches[i];
  os << "}";
  return os.str();
}

std::string RegisteredSchemas() {
  std::ostringstream os;
  for (const char* k : kKernels) {
    auto op = c10::Dispatcher::singleton().findSchemaOrThrow(
        (std::string("ptpu::") + k).c_str(), "");
    os << c10::toString(op.schema()) << "\n";
  }
  return os.str();
}

#ifdef PTPU_WITH_CUDA
bool BuiltWithCuda() { return true; }

std::shared_ptr<void> UseOwnStream(c10::Device device) {
  if (!device.is_cuda()) return nullptr;
  return std::make_shared<c10::cuda::CUDAStreamGuard>(
      c10::cuda::getStreamFromPool(false, device.index()));
}

void Synchronize(c10::Device device) {
  if (device.is_cuda()) c10::cuda::device_synchronize();
}
#else
bool BuiltWithCuda() { return false; }

std::shared_ptr<void> UseOwnStream(c10::Device) { return nullptr; }

void Synchronize(c10::Device) {}
#endif

}  // namespace ptpu

#ifdef PTPU_WITH_CUDA

extern "C" {
const char* ptt_cuda_error_string(int err);
int ptt_flash_fwd(int is_bf16, int D, const void* q, const void* k,
                  const void* v, const int* qseg, const int* kvseg, void* out,
                  float* lse, int BH, int H, int Tq, int Tk, float scale,
                  int causal, void* stream);
int ptt_flash_bwd_dq(int is_bf16, int D, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, const int* qseg, const int* kvseg,
                     void* dq, int BH, int H, int Tq, int Tk, float scale,
                     int causal, void* stream);
int ptt_flash_bwd_dkv(int is_bf16, int D, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, const int* qseg, const int* kvseg,
                      void* dk, void* dv, int BH, int H, int Tq, int Tk,
                      float scale, int causal, void* stream);
int ptt_decode_attention_chunk(int R, int nh, int T, int dh);
int ptt_decode_attention(int q_is_bf16, int k_type, int v_type,
                         const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         int n_kscale, int n_vscale, const void* bias,
                         void* out, void* scratch, int n_split, int R, int nh,
                         int G, int T, int dh, long long bias_row_stride,
                         long long bias_head_stride, long long bias_g_stride,
                         float scale, void* stream);
int ptt_recurrent_plan(int kind, int B, int H, int* out);
int ptt_lstm_seq(const void* x, const void* w, const void* w_rel,
                 const void* h0, const void* c0, const void* seqlen, int B,
                 int T, int H, int reverse, int dtype, void* hs, void* cs,
                 void* stash, void* hbuf, void* arrived, void* stream);
int ptt_gru_seq(const void* x, const void* w, const void* w_rel,
                const void* h0, const void* seqlen, int B, int T, int H,
                int reverse, int dtype, void* hs, void* stash, void* buf,
                void* arrived, void* stream);
}

namespace {

using at::Tensor;
using OptT = std::optional<Tensor>;

void Check(int err, const char* name) {
  TORCH_CHECK(err == 0, name, " kernel launch failed: CUDA error ", err, " (",
              ptt_cuda_error_string(err), ")");
}

void* Stream(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

const void* Ptr(const OptT& t) {
  return t.has_value() && t->defined() ? t->data_ptr() : nullptr;
}

// The flash kernels' head dims (ops/flash_attention.py KERNEL_HEAD_DIMS,
// and any multiple of WIDE_COLS above 256).
bool KernelHeadDim(int64_t d) {
  return d == 32 || d == 64 || d == 128 || d == 256 || (d > 256 && d % 128 == 0);
}

void FlashCheck(const char* name, const Tensor& q, const Tensor& k,
                const std::vector<const Tensor*>& like,
                const OptT& q_ids, const OptT& kv_ids) {
  TORCH_CHECK(q.is_cuda(), name, ": every tensor must be on one CUDA device");
  TORCH_CHECK(q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16,
              name, ": q/k/v must be float32 or bfloat16");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && KernelHeadDim(q.size(3)), name,
              ": [B, H, T, D] tensors at a head dim the kernels take");
  for (const Tensor* t : like) {
    TORCH_CHECK(t->device() == q.device() && t->is_contiguous() &&
                    reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                name, ": tensors must be contiguous, 16-byte aligned, on q's "
                "device");
  }
  for (const OptT* ids : {&q_ids, &kv_ids})
    if (ids->has_value())
      TORCH_CHECK((*ids)->scalar_type() == at::kInt && (*ids)->is_contiguous(),
                  name, ": segment ids must be contiguous int32");
}

std::tuple<Tensor, Tensor> FlashFwd(const Tensor& q, const Tensor& k,
                                    const Tensor& v, const OptT& q_ids,
                                    const OptT& kv_ids, double scale,
                                    bool causal, bool with_lse) {
  FlashCheck("flash_fwd", q, k, {&q, &k, &v}, q_ids, kv_ids);
  c10::cuda::CUDAGuard guard(q.device());
  const int64_t b = q.size(0), h = q.size(1), tq = q.size(2), d = q.size(3);
  Tensor o = at::empty_like(q);
  Tensor lse = at::empty(with_lse ? std::vector<int64_t>{b, h, tq}
                                  : std::vector<int64_t>{0},
                         q.options().dtype(at::kFloat));
  Check(ptt_flash_fwd(q.scalar_type() == at::kBFloat16, d, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(),
                      static_cast<const int*>(Ptr(q_ids)),
                      static_cast<const int*>(Ptr(kv_ids)), o.data_ptr(),
                      with_lse ? lse.data_ptr<float>() : nullptr, b * h, h,
                      tq, k.size(2), static_cast<float>(scale), causal,
                      Stream(q)),
        "flash_fwd");
  ++g_launches[0];
  return {o, lse};
}

Tensor FlashBwdDq(const Tensor& q, const Tensor& k, const Tensor& v,
                  const Tensor& dout, const Tensor& lse, const Tensor& delta,
                  const OptT& q_ids, const OptT& kv_ids, double scale,
                  bool causal) {
  FlashCheck("flash_bwd_dq", q, k, {&q, &k, &v, &dout, &lse, &delta}, q_ids,
             kv_ids);
  c10::cuda::CUDAGuard guard(q.device());
  const int64_t b = q.size(0), h = q.size(1), tq = q.size(2), d = q.size(3);
  Tensor dq = at::empty_like(q);
  Check(ptt_flash_bwd_dq(q.scalar_type() == at::kBFloat16, d, q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                         lse.data_ptr<float>(), delta.data_ptr<float>(),
                         static_cast<const int*>(Ptr(q_ids)),
                         static_cast<const int*>(Ptr(kv_ids)), dq.data_ptr(),
                         b * h, h, tq, k.size(2), static_cast<float>(scale),
                         causal, Stream(q)),
        "flash_bwd_dq");
  ++g_launches[1];
  return dq;
}

std::tuple<Tensor, Tensor> FlashBwdDkv(const Tensor& q, const Tensor& k,
                                       const Tensor& v, const Tensor& dout,
                                       const Tensor& lse, const Tensor& delta,
                                       const OptT& q_ids, const OptT& kv_ids,
                                       double scale, bool causal) {
  FlashCheck("flash_bwd_dkv", q, k, {&q, &k, &v, &dout, &lse, &delta}, q_ids,
             kv_ids);
  c10::cuda::CUDAGuard guard(q.device());
  const int64_t b = q.size(0), h = q.size(1), tq = q.size(2), d = q.size(3);
  Tensor dk = at::empty_like(k), dv = at::empty_like(v);
  Check(ptt_flash_bwd_dkv(q.scalar_type() == at::kBFloat16, d, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                          lse.data_ptr<float>(), delta.data_ptr<float>(),
                          static_cast<const int*>(Ptr(q_ids)),
                          static_cast<const int*>(Ptr(kv_ids)), dk.data_ptr(),
                          dv.data_ptr(), b * h, h, tq, k.size(2),
                          static_cast<float>(scale), causal, Stream(q)),
        "flash_bwd_dkv");
  ++g_launches[2];
  return {dk, dv};
}

// fusion/decode_attention.py _CACHE_TYPES
int CacheType(const Tensor& t) {
  switch (t.scalar_type()) {
    case at::kFloat: return 0;
    case at::kChar: return 1;
    case at::kBFloat16: return 2;
    default: TORCH_CHECK(false, "decode_attention: K and V must be float32, "
                         "bfloat16 or int8");
  }
}

Tensor DecodeAttention(const Tensor& q, const Tensor& k, const Tensor& v,
                       const Tensor& bias, double scale, const OptT& k_scale,
                       const OptT& v_scale) {
  TORCH_CHECK(q.is_cuda() && k.device() == q.device() &&
                  v.device() == q.device() && bias.device() == q.device(),
              "decode_attention: every tensor must be on the same CUDA device");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && bias.dim() == 4,
              "decode_attention: q [R, nh, G, dh], K/V [R, nh, T, dh], bias "
              "[R, nh, G, T]");
  TORCH_CHECK(q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16,
              "decode_attention: q must be float32 or bfloat16");
  TORCH_CHECK(bias.scalar_type() == at::kFloat && bias.stride(3) == 1,
              "decode_attention: bias float32, unit-stride along T");
  TORCH_CHECK(q.is_contiguous() && k.is_contiguous() && v.is_contiguous(),
              "decode_attention: q, K, V must be contiguous");
  const int r = q.size(0), nh = q.size(1), g = q.size(2), dh = q.size(3);
  const int t = k.size(2);
  c10::cuda::CUDAGuard guard(q.device());
  const int chunk = ptt_decode_attention_chunk(r, nh, t, dh);
  TORCH_CHECK(chunk >= 1, "decode_attention: the kernel does not take R=", r,
              " nh=", nh, " T=", t, " dh=", dh);
  const int n_split = (t + chunk - 1) / chunk;
  Tensor out = at::empty({r, nh, g, dh}, q.options());
  Tensor part = at::empty({int64_t(r) * nh, n_split, g, dh + 2},
                          q.options().dtype(at::kFloat));
  const bool ks = k.scalar_type() == at::kChar, vs = v.scalar_type() == at::kChar;
  TORCH_CHECK(ks == (k_scale.has_value() && k_scale->defined()) &&
                  vs == (v_scale.has_value() && v_scale->defined()),
              "decode_attention: an int8 cache, and only one, takes scales");
  Check(ptt_decode_attention(
            q.scalar_type() == at::kBFloat16, CacheType(k), CacheType(v),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), Ptr(k_scale),
            Ptr(v_scale), ks ? k_scale->size(2) : 1, vs ? v_scale->size(2) : 1,
            bias.data_ptr(), out.data_ptr(), part.data_ptr(), n_split, r, nh, g,
            t, dh, bias.stride(0), bias.stride(1), bias.stride(2),
            static_cast<float>(scale), Stream(q)),
        "decode_attention");
  ++g_launches[3];
  return out;
}

struct Plan {
  int ug, groups, blocks, stream_w, smem, hp;
};

// fusion/recurrent.py recurrent_plan, cached per (kind, B, H, device)
Plan RecurrentPlan(int kind, int b, int hd, int device) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, Plan> plans;
  std::lock_guard<std::mutex> lk(mu);
  auto key = std::make_tuple(kind, b, hd, device);
  auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  int out[6];
  Check(ptt_recurrent_plan(kind, b, hd, out), kind ? "gru_seq plan"
                                                   : "lstm_seq plan");
  Plan p{out[0], out[1], out[2], out[3], out[4], out[5]};
  plans[key] = p;
  return p;
}

// fusion/recurrent.py relay_w: w [H, G·H] laid out block by block, float32
Tensor RelayW(const Tensor& w, int n_gates, const Plan& p) {
  const int64_t hd = w.size(0);
  Tensor wf = w.to(at::kFloat);
  Tensor wp = wf.new_zeros({p.hp, n_gates, int64_t(p.blocks) * p.groups * p.ug});
  wp.slice(0, 0, hd).slice(2, 0, hd).copy_(wf.reshape({hd, n_gates, hd}));
  return wp.reshape({p.hp, n_gates, p.blocks, p.groups, p.ug})
      .permute({2, 3, 0, 1, 4})
      .reshape({p.blocks, p.groups, p.hp, n_gates * p.ug})
      .contiguous();
}

int TypeCode(const Tensor& x) {
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "recurrent kernels take float32 or bfloat16");
  return x.scalar_type() == at::kFloat ? 0 : 1;
}

std::tuple<Tensor, Tensor, Tensor> LstmSeq(const Tensor& x_, const Tensor& h0_,
                                           const Tensor& c0_, const Tensor& w_,
                                           const Tensor& seqlen, bool reverse,
                                           bool with_stash) {
  TORCH_CHECK(x_.is_cuda() && x_.dim() == 3 && w_.dim() == 2 &&
                  h0_.scalar_type() == x_.scalar_type() &&
                  c0_.scalar_type() == x_.scalar_type() &&
                  w_.scalar_type() == x_.scalar_type(),
              "lstm_seq: x [B, T, 4H], w [H, 4H], states [B, H] of one type "
              "on one CUDA device");
  c10::cuda::CUDAGuard guard(x_.device());
  const int b = x_.size(0), t = x_.size(1), hd = w_.size(0);
  TORCH_CHECK(x_.size(2) == 4 * hd && w_.size(1) == 4 * hd,
              "lstm_seq: shapes do not agree");
  const Plan p = RecurrentPlan(0, b, hd, x_.device().index());
  Tensor x = x_.contiguous(), h0 = h0_.contiguous(), c0 = c0_.contiguous(),
         w = w_.contiguous();
  Tensor w_rel = p.stream_w ? RelayW(w, 4, p) : Tensor();
  Tensor sl = seqlen.to(at::kInt).contiguous();
  Tensor hs = at::empty({b, t, hd}, x.options());
  Tensor cs = at::empty_like(hs);
  Tensor stash = at::empty(with_stash ? std::vector<int64_t>{b, t, 4 * hd}
                                      : std::vector<int64_t>{0},
                           x.options());
  Tensor hbuf = at::zeros({2, b, p.hp}, x.options().dtype(at::kFloat));
  Tensor arrived = at::zeros({1}, x.options().dtype(at::kInt));
  Check(ptt_lstm_seq(x.data_ptr(), w.data_ptr(),
                     w_rel.defined() ? w_rel.data_ptr() : nullptr,
                     h0.data_ptr(), c0.data_ptr(), sl.data_ptr(), b, t, hd,
                     reverse, TypeCode(x), hs.data_ptr(), cs.data_ptr(),
                     with_stash ? stash.data_ptr() : nullptr, hbuf.data_ptr(),
                     arrived.data_ptr(), Stream(x)),
        "lstm_seq");
  ++g_launches[4];
  return {hs, cs, stash};
}

std::tuple<Tensor, Tensor> GruSeq(const Tensor& x_, const Tensor& h0_,
                                  const Tensor& w_, const Tensor& seqlen,
                                  bool reverse, bool with_stash) {
  TORCH_CHECK(x_.is_cuda() && x_.dim() == 3 && w_.dim() == 2 &&
                  h0_.scalar_type() == x_.scalar_type() &&
                  w_.scalar_type() == x_.scalar_type(),
              "gru_seq: x [B, T, 3H], w [H, 3H], h0 [B, H] of one type on one "
              "CUDA device");
  c10::cuda::CUDAGuard guard(x_.device());
  const int b = x_.size(0), t = x_.size(1), hd = w_.size(0);
  TORCH_CHECK(x_.size(2) == 3 * hd && w_.size(1) == 3 * hd,
              "gru_seq: shapes do not agree");
  const Plan p = RecurrentPlan(1, b, hd, x_.device().index());
  Tensor x = x_.contiguous(), h0 = h0_.contiguous(), w = w_.contiguous();
  Tensor w_rel = p.stream_w ? RelayW(w, 3, p) : Tensor();
  Tensor sl = seqlen.to(at::kInt).contiguous();
  Tensor hs = at::empty({b, t, hd}, x.options());
  Tensor stash = at::empty(with_stash ? std::vector<int64_t>{b, t, 3 * hd}
                                      : std::vector<int64_t>{0},
                           x.options());
  Tensor buf = at::zeros({3, b, p.hp}, x.options().dtype(at::kFloat));
  Tensor arrived = at::zeros({1}, x.options().dtype(at::kInt));
  Check(ptt_gru_seq(x.data_ptr(), w.data_ptr(),
                    w_rel.defined() ? w_rel.data_ptr() : nullptr,
                    h0.data_ptr(), sl.data_ptr(), b, t, hd, reverse,
                    TypeCode(x), hs.data_ptr(),
                    with_stash ? stash.data_ptr() : nullptr, buf.data_ptr(),
                    arrived.data_ptr(), Stream(x)),
        "gru_seq");
  ++g_launches[5];
  return {hs, stash};
}

}  // namespace

TORCH_LIBRARY_IMPL(ptpu, CUDA, m) {
  m.impl("flash_fwd", &FlashFwd);
  m.impl("flash_bwd_dq", &FlashBwdDq);
  m.impl("flash_bwd_dkv", &FlashBwdDkv);
  m.impl("decode_attention", &DecodeAttention);
  m.impl("lstm_seq", &LstmSeq);
  m.impl("gru_seq", &GruSeq);
}

#endif  // PTPU_WITH_CUDA
