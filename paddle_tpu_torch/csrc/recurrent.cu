// Whole-sequence LSTM and GRU recurrences for Hopper (sm_90a): every time
// step of one sequence batch in a single launch.
//
// Replaces paddle_tpu/fusion/recurrent.py:_lstm_seq_kernel (LSTM, K5) and
// _gru_seq_kernel (GRU, K6), both driven by _pallas_seq. They compute what
// those kernels compute, in float32, or for bfloat16 x, w and states what
// the reference's XLA composite computes for them (_xla_lstm_seq /
// _xla_gru_seq, which the JAX package takes for any type but float32):
//
//   LSTM  gates (i, f, c^, o) = x_t + h . w     (x [B,T,4H], w [H,4H])
//         c = sig(f) c + sig(i) tanh(c^),  h = sig(o) tanh(c)
//   GRU   r, z = sig(x_t[:, :2H] + h . w[:, :2H])            (w [H,3H])
//         c = tanh(x_t[:, 2H:] + (r h) . w[:, 2H:]),  h = z h + (1 - z) c
//
// A row whose step position (t, or T-1-t for a reversed sequence whose x the
// caller flipped) is not below its length keeps its state; the gate stash
// (i, f, c^, o) or (r, z, c), written when asked for, holds the values the
// step computed either way, as the TPU kernels' stash does.
//
// The TPU kernel walks a (batch block, t) grid in order with h and c in
// VMEM scratch and all of w resident. No SM can hold w (4 MB at H = 512),
// and blocks neither run in order nor share memory, so both kernels here
// are persistent cooperative kernels: block g owns a few hidden units for
// every batch row and keeps their gate columns of w on chip for the whole
// sequence, so the cell update is local. Only h crosses blocks: each step
// every block writes its units' new h into a buffer in global memory (it
// stays in L2) and reads everyone's after one grid-wide barrier. The LSTM
// needs one barrier per step (h double-buffered); the GRU two, because its
// candidate product needs r h of units other blocks own: phase A computes
// r, z and publishes r h, a barrier, phase B the candidate and the new h, a
// barrier. Float32 FMAs on the CUDA cores in both (TF32 tensor cores would
// change the results the plain version gives: later work, with a bound).
//
// Bound on this card: at the stacked LSTM's shape (B 64, T 100, H 512) the
// recurrent products are 2 B T H 4H = 13.4 GFLOP (~0.2 ms at 67 TFLOP/s
// float32) against ~135 MB of inputs and outputs (~40 us), so operations
// bound it, with T grid barriers (2T for the GRU) as a serial floor beside;
// the GRU at the NMT encoder's shape (B 32, T 64, H 512) likewise, 2 B T H
// 3H = 3.2 GFLOP (~48 us) against ~33 MB (~10 us).
//
// K5 (lstm_seq_kernel), the Hopper design. What held the first design back
// was latency, not FMAs: h was staged 128 columns by 32 rows at a time,
// eight serial L2 round trips and sixteen block barriers a step, with one
// block of 8 warps on each SM and nothing to hide them. Now:
//  - each warp owns an eighth of k. Right after the grid barrier it issues
//    16-byte cp.async.cg copies (read from L2, where the other SMs' writes
//    are) of its k columns of h_{t-1} for 64 batch rows, in pieces of 16
//    columns into a ring of 4 slots of its own, and multiplies each piece
//    as it lands (cp.async.wait_group; no block barrier, since the warp is
//    the only reader of what it copied). At H <= 512 the whole of h is in
//    flight at once, one L2 round trip a step; a larger H cycles the ring;
//  - every batch row of the pass in one product: a lane holds a register
//    tile of 8 rows (rg + 8 i) by 8 gate columns over its half of each
//    piece (two k-splits a warp, 16 a block), so it loads 16 floats from
//    shared memory for 64 FMAs (h as float4 from rows padded to 20 floats,
//    conflict-free; w as float4 broadcasts). One shared-memory reduction
//    of the 16 k-splits' partial sums (written over the warps' own rings)
//    serves every row, and thread (row, unit) then updates that cell from
//    its 4 gates;
//  - the x gate loads, and the previous c (read back from cs, which the
//    same thread wrote a step before), are issued before the product;
//  - the grid barrier posts a release add and polls with acquire loads
//    (grid_sync), with no full fences and no wait for the add's result;
//  - any H: blocks own U units (1, 2, 4, or a multiple of 4 when H needs
//    more than 4 an SM), handled as column groups of 4 units; w stays in
//    shared memory when it fits beside the rings, and is otherwise read
//    through the same rings from a copy laid out [block][group][H'][16]
//    (H' = H rounded up to 4; zeros past H) that the wrapper builds; more
//    than 64 batch rows take several passes.
// What a step of K5 or K6 still spends, by part (the product, the staging
// of h, where every SM reads all of h from L2 each step, the barriers and
// the stores), is measured by probe_recurrent.py; PERF.md has its numbers.
//
// K6 (gru_seq_kernel) has K5's design, sized to the GRU: see "K6" below.
//
// bfloat16 (E = __nv_bfloat16): x, w, h0, c0 and the outputs hs, cs and the
// stash are bfloat16. The composite's scan carries h and c in x's type, so
// they are rounded to bfloat16 at every step; the kernels keep float32
// arithmetic inside a step (the product accumulates in float32, as the
// composite's dot does) and round the carried state where the composite
// stores it: the new h (into the h buffer every block reads next step) and
// the new c, and every output as it is written. w is widened to float32 as
// a block stages it (the relaid copy is float32 already); the h buffers
// stay float32 and hold bfloat16 values exactly. So an error does not grow
// with T beyond what the rounded carry itself does.
//
// Launch: ptt_recurrent_plan picks the units a block so that the blocks are
// no more than the SMs, one block on each; cudaLaunchCooperativeKernel
// guarantees they are co-resident, which the barrier needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kF32 = 0;    // element type codes of ptt_lstm_seq / ptt_gru_seq
constexpr int kBF16 = 1;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// Element loads and stores in the inputs' type E (float or bfloat16), and
// the rounding of a float32 value to E.
__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_e(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_e(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename E>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(E) == sizeof(float)) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// Grid-wide barrier over a counter that only grows (zeroed by the caller):
// each block adds 1 as it arrives, and barrier n is passed once the counter
// reaches n blocks' worth (`target`, kept by each block's thread 0). The
// add is a release (it publishes the block's global writes, which the
// block barrier before it orders first) and is posted without waiting for
// its result; the polling load is an acquire (the block's later reads see
// everyone's writes). A wait beyond ~2^34 clocks (about ten seconds) means
// a block never arrived: the kernel traps, which the caller sees as a CUDA
// error, instead of holding the card.
__device__ __forceinline__ void grid_sync(unsigned int* arrived,
                                          unsigned int& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(arrived)
                 : "memory");
    const long long start = clock64();
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(now)
                   : "l"(arrived)
                   : "memory");
      if (clock64() - start > (1ll << 34)) __trap();
    } while (static_cast<int>(now - target) < 0);
  }
  __syncthreads();
}

// --- K5: the LSTM ---------------------------------------------------------

constexpr int kPass = 64;              // batch rows a pass: two a lane
constexpr int kKC = 16;                // k columns of h a staged piece
constexpr int kLdh = kKC + 4;          // staged row stride: float4 reads
                                       // of 8 lanes hit 32 distinct banks
constexpr int kNS = 4;                 // ring slots a warp
constexpr int kSlotH = kPass * kLdh;   // floats of h in a slot

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // zero-fills the 16 bytes where !valid (src-size 0)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats of one warp's ring slot: h [kPass][kLdh], then the piece's rows of
// w [kKC][NCT] where w is streamed.
__host__ __device__ constexpr int lstm_slot_floats(int nct, bool stream_w) {
  return kSlotH + (stream_w ? kKC * nct : 0);
}

// K5. UG units a column group (1, 2 or 4), `groups` column groups a block;
// w_rel is null where the block's w columns are kept in shared memory, else
// the relaid copy [gridDim.x][groups][HP][4 UG] they are streamed from.
// hbuf [2][B][HP], zeroed by the caller (columns H..HP-1 stay 0).
template <int UG, typename E>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_kernel(const E* __restrict__ x, const E* __restrict__ w,
                const float* __restrict__ w_rel,
                const E* __restrict__ h0, const E* __restrict__ c0,
                const int* __restrict__ seqlen, int B, int T, int H, int HP,
                int groups, int reverse, E* __restrict__ hs,
                E* __restrict__ cs, E* __restrict__ stash,
                float* hbuf, unsigned int* arrived) {
  constexpr int NCT = 4 * UG;          // gate columns of a group: g UG + u
  constexpr int CT = NCT < 8 ? NCT : 8;  // of which a lane takes CT
  constexpr int NCG = NCT / CT;        // lanes across a group's columns
  constexpr int KSW = 4 / NCG;         // k-splits a warp
  constexpr int KL = kKC / KSW;        // k of each piece a k-split takes
  constexpr int LDR = NCT + 4;         // row stride of the partial sums
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a lane's register tile: rows rg + 8 i (i < 8) by columns cgp CT + c,
  // over k-split ks of the warp's pieces; the 8 lanes of a quarter warp
  // take 8 neighbouring rows, so their float4 reads of h hit distinct banks
  const int rg = lane & 7;
  const int cgp = (lane >> 3) % NCG;
  const int ks = (lane >> 3) / NCG;
  const bool stream_w = w_rel != nullptr;
  const int slot = lstm_slot_floats(NCT, stream_w);
  float* ring = smem + warp * kNS * slot;
  float* w_s = smem + kWarps * kNS * slot;   // [groups][HP][NCT]
  const int U = UG * groups;
  const int j0 = blockIdx.x * U;
  const size_t bhp = (size_t)B * HP;
  // this warp's share of k: [kb, ke), in pieces of kKC
  const int kw = ((HP / 4 + kWarps - 1) / kWarps) * 4;
  const int kb = min(HP, warp * kw);
  const int ke = min(HP, kb + kw);
  const int nj = (ke - kb + kKC - 1) / kKC;
  const float* w_blk =
      stream_w ? w_rel + (size_t)blockIdx.x * groups * HP * NCT : w_s;

  if (!stream_w) {
    for (int p = threadIdx.x; p < groups * HP * NCT; p += kThreads) {
      const int cg = p / (HP * NCT);
      const int k = (p / NCT) % HP;
      const int c = p % NCT;
      const int j = j0 + cg * UG + c % UG;
      w_s[p] = (k < H && j < H)
                   ? ld_f(w + (size_t)k * 4 * H + (size_t)(c / UG) * H + j)
                   : 0.f;
    }
  }
  for (int p = threadIdx.x; p < B * U; p += kThreads) {
    const int b = p / U;
    const int j = j0 + p % U;
    if (j < H) hbuf[(size_t)b * HP + j] = ld_f(h0 + (size_t)b * H + j);
  }
  unsigned int target = 0;
  grid_sync(arrived, target);

  // the (row, unit) this thread updates in every tile
  const int pr = threadIdx.x / UG;
  const int pu = threadIdx.x % UG;
  const int tiles = ((B + kPass - 1) / kPass) * groups;
  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * bhp;
    float* hnxt = hbuf + ((t + 1) & 1) * bhp;
    const int tpos = reverse ? T - 1 - t : t;
    for (int tile = 0; tile < tiles; ++tile) {
      const int row0 = (tile / groups) * kPass;
      const int cg = tile % groups;
      const float* w_g = w_blk + (size_t)cg * HP * NCT;   // [HP][NCT]
      const int b = row0 + pr;
      const int j = j0 + cg * UG + pu;
      const bool mine = pr < kPass && b < B && j < H;
      const size_t xo = ((size_t)b * T + t) * 4 * H + j;
      float xg[4], hprev = 0.f, cprev = 0.f;
      if (mine) {  // in flight while the product runs
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = ld_f(x + xo + (size_t)g * H);
        hprev = hcur[(size_t)b * HP + j];
        cprev = t == 0 ? ld_f(c0 + (size_t)b * H + j)
                       : ld_f(cs + ((size_t)b * T + t - 1) * H + j);
      }

      // piece q of this warp's k share into ring slot q % kNS (an empty
      // commit group past the last piece keeps the wait count constant)
      auto issue = [&](int q) {
        if (q < nj) {
          float* sl = ring + (q % kNS) * slot;
          const int k0 = kb + q * kKC;
          for (int i = lane; i < kPass * kKC / 4; i += 32) {
            const int r = i / (kKC / 4);
            const int k = k0 + (i % (kKC / 4)) * 4;
            const bool ok = row0 + r < B && k < ke;
            cp_async16(sl + r * kLdh + (k - k0),
                       ok ? hcur + (size_t)(row0 + r) * HP + k : hcur, ok);
          }
          if (stream_w) {
            for (int i = lane; i < kKC * NCT / 4; i += 32) {
              const int k = k0 + i / (NCT / 4);
              const int c = (i % (NCT / 4)) * 4;
              const bool ok = k < ke;
              cp_async16(sl + kSlotH + (k - k0) * NCT + c,
                         ok ? w_g + (size_t)k * NCT + c : w_g, ok);
            }
          }
        }
        cp_async_commit();
      };

      float acc[8][CT];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
#pragma unroll
      for (int q = 0; q < kNS - 1; ++q) issue(q);
      for (int q = 0; q < nj; ++q) {
        __syncwarp();  // every lane is done with the slot piece q+kNS-1 takes
        issue(q + kNS - 1);
        cp_async_wait<kNS - 1>();  // piece q has landed
        __syncwarp();
        const float* sl = ring + (q % kNS) * slot;
        const int k0 = kb + q * kKC;
        const int kn = min(kKC, ke - k0);
        const float* hr = sl + rg * kLdh + ks * KL;
        const float* wc =
            (stream_w ? sl + kSlotH : w_g + (size_t)k0 * NCT) +
            ks * KL * NCT + cgp * CT;
#pragma unroll
        for (int kq = 0; kq < KL; kq += 4) {
          if (ks * KL + kq < kn) {
            float4 hv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              hv[i] = *reinterpret_cast<const float4*>(hr + i * 8 * kLdh +
                                                        kq);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float wv[CT];
#pragma unroll
              for (int c = 0; c < CT; c += 4) {
                const float4 v = *reinterpret_cast<const float4*>(
                    wc + (kq + kk) * NCT + c);
                wv[c] = v.x;
                wv[c + 1] = v.y;
                wv[c + 2] = v.z;
                wv[c + 3] = v.w;
              }
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float a = kk == 0   ? hv[i].x
                                : kk == 1 ? hv[i].y
                                : kk == 2 ? hv[i].z
                                          : hv[i].w;
#pragma unroll
                for (int c = 0; c < CT; ++c)
                  acc[i][c] = fmaf(a, wv[c], acc[i][c]);
              }
            }
          }
        }
      }
      // the partial sums over this warp's own ring ([KSW][kPass][LDR]),
      // then every thread adds the 16 k-splits' sums for its (row, unit)
      __syncwarp();
      float* red = ring + ks * kPass * LDR + cgp * CT;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CT; c += 4)
          *reinterpret_cast<float4*>(red + (rg + 8 * i) * LDR + c) =
              make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2],
                          acc[i][c + 3]);
      __syncthreads();
      if (mine) {
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) {
#pragma unroll
          for (int sp = 0; sp < KSW; ++sp) {
            const float* rw =
                smem + wp * kNS * slot + (sp * kPass + pr) * LDR + pu;
#pragma unroll
            for (int g = 0; g < 4; ++g) xg[g] += rw[g * UG];
          }
        }
        const float ig = sigmoid_f(xg[0]);
        const float fg = sigmoid_f(xg[1]);
        const float gg = tanhf(xg[2]);
        const float og = sigmoid_f(xg[3]);
        // the carried state in E: the new c is rounded before h reads it
        float cn = round_to<E>(fg * cprev + ig * gg);
        float hn = round_to<E>(og * tanhf(cn));
        if (seqlen[b] <= tpos) {
          cn = cprev;
          hn = hprev;
        }
        hnxt[(size_t)b * HP + j] = hn;
        const size_t so = ((size_t)b * T + t) * H + j;
        st_e(hs + so, hn);
        st_e(cs + so, cn);
        if (stash != nullptr) {
          st_e(stash + xo, ig);
          st_e(stash + xo + H, fg);
          st_e(stash + xo + 2 * H, gg);
          st_e(stash + xo + 3 * H, og);
        }
      }
      __syncthreads();  // the rings are free for the next tile's pieces
    }
    grid_sync(arrived, target);
  }
}

// --- K6: the GRU ----------------------------------------------------------
//
// K6 (gru_seq_kernel), K5's design sized to the GRU. A step is two phases
// with a grid barrier after each (the candidate's product needs r h of
// units other blocks own): phase A multiplies h by the r and z columns of
// the block's units and publishes r h (and z, for phase B); phase B
// multiplies r h by the candidate columns and writes the new h. In each
// phase, for each tile of kPassG = 32 batch rows (the NMT encoder's batch:
// one pass) and column group of UG units:
//  - staging: right after the barrier each warp issues 16-byte
//    cp.async.cg copies of its eighth of k of h (phase A) or r h (phase
//    B), in pieces of 32 columns by 32 rows into a ring of 4 slots of its
//    own, and multiplies each piece as it lands; no block barrier stands
//    between a copy and its product. At H <= 1024 a warp's whole share is
//    in flight at once: one L2 round trip a phase;
//  - register tiles: a lane holds 8 rows (rg + 4 i) by all NC gate columns
//    of the phase (NC = 2 UG in phase A, UG in phase B) over 4 of each
//    piece's 32 columns (eight k-splits a warp, 64 a block). Per k it loads
//    8 floats of h (as float4 over 4 k, rows padded to 40 floats: the
//    quarter warp's 4 rows x 2 k-splits hit 32 distinct banks) and NC of w
//    (float4 broadcasts; at NC = 8 rows of w are padded by 4 floats every
//    4 rows so the quarter warp's two k-splits read distinct banks), so at
//    UG = 4 (the NMT shape, 4 units a block) phase A loads 16 floats for 64
//    FMAs and phase B 12 floats for 32 FMAs (the first design: 3 for 8 and
//    2 for 4);
//  - one shared-memory reduction of the 64 k-splits' partial sums,
//    written over the warps' own rings, then thread (row, gate column)
//    finishes its gate: one thread per output;
//  - the x gate loads, and in phase B z and the previous h of the owned
//    units (both from global scratch the block wrote, in L2), are issued
//    before the product;
//  - the barriers are K5's grid_sync.
// Any H: blocks own U units (1, 2, 4, or a multiple of 4), handled as
// column groups of UG = min(U, 4); w stays in shared memory where it fits
// beside the rings and is otherwise streamed through the same rings from
// relay_w's copy [block][group][HP][3 UG] (UG = 4: rows of whole 16-byte
// pieces); more than 32 batch rows take several passes.

constexpr int kPassG = 32;             // GRU batch rows a pass: 8 a lane
constexpr int kKG = 32;                // k columns of h (or r h) a piece
constexpr int kLdg = kKG + 8;          // staged row stride (see above)
constexpr int kSlotG = kPassG * kLdg;  // floats of h in a slot

// Offset of row k of a block of w's gate columns, nc a row, in shared
// memory: at nc = 8, 4 floats of padding after every 4 rows (k-splits are
// 4 rows apart: 36 floats, not 32, so two of them use distinct banks).
__host__ __device__ constexpr int gru_wrow(int nc, int k) {
  return k * nc + (nc == 8 ? (k >> 2) * 4 : 0);
}

// Floats of one warp's ring slot: h [kPassG][kLdg], then the piece's rows
// of w (phase A's 2 UG columns, the wider phase) where w is streamed.
__host__ __device__ constexpr int gru_slot_floats(int ug, bool stream_w) {
  return kSlotG + (stream_w ? gru_wrow(2 * ug, kKG) : 0);
}

// One phase's product for the tile of rows row0 .. row0 + kPassG - 1: this
// warp's k share [kb, ke) of src ([B][HP], written by every block before
// the last grid barrier) comes through the warp's ring in pieces of kKG
// columns, each multiplied as it lands by the phase's NC gate columns of
// w: resident (w_s, rows by gru_wrow) or, where w_g is not null, streamed
// beside the piece from the relaid copy (rows of ldg floats, w_g at the
// phase's first column). acc[i][c]: row rg + 4 i, column c, over the
// lane's k-split (columns 4 ks .. 4 ks + 3 of each piece).
template <int NC>
__device__ __forceinline__ void gru_product(float (&acc)[8][NC],
                                            const float* src, int B, int HP,
                                            int row0, int kb, int ke,
                                            float* ring, int slot,
                                            const float* w_s,
                                            const float* w_g, int ldg) {
  const int lane = threadIdx.x & 31;
  const int rg = lane & 3, ks = lane >> 2;
  const int nj = (ke - kb + kKG - 1) / kKG;
  // piece q into ring slot q % kNS (an empty commit group past the last
  // piece keeps the wait count constant)
  auto issue = [&](int q) {
    if (q < nj) {
      float* piece = ring + (q % kNS) * slot;
      const int k0 = kb + q * kKG;
      for (int i = lane; i < kPassG * kKG / 4; i += 32) {
        const int r = i / (kKG / 4);
        const int k = k0 + (i % (kKG / 4)) * 4;
        const bool ok = row0 + r < B && k < ke;
        cp_async16(piece + r * kLdg + (k - k0),
                   ok ? src + (size_t)(row0 + r) * HP + k : src, ok);
      }
      if constexpr (NC % 4 == 0) {
        if (w_g != nullptr) {
          for (int i = lane; i < kKG * NC / 4; i += 32) {
            const int kk = i / (NC / 4);
            const int c = (i % (NC / 4)) * 4;
            const bool ok = k0 + kk < ke;
            cp_async16(piece + kSlotG + gru_wrow(NC, kk) + c,
                       ok ? w_g + (size_t)(k0 + kk) * ldg + c : w_g, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int q = 0; q < kNS - 1; ++q) issue(q);
  for (int q = 0; q < nj; ++q) {
    __syncwarp();  // every lane is done with the slot piece q+kNS-1 takes
    issue(q + kNS - 1);
    cp_async_wait<kNS - 1>();  // piece q has landed
    __syncwarp();
    const float* piece = ring + (q % kNS) * slot;
    const int k0 = kb + q * kKG;
    const int kn = ke - k0;
    if (ks * 4 < kn) {
      const float* hr = piece + rg * kLdg + ks * 4;
      const float* wr =
          (w_g != nullptr ? piece + kSlotG : w_s + gru_wrow(NC, k0)) +
          gru_wrow(NC, ks * 4);
      float4 hv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hr + i * 4 * kLdg);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wv[NC];
        if constexpr (NC % 4 == 0) {
#pragma unroll
          for (int c = 0; c < NC; c += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(wr + kk * NC + c);
            wv[c] = v.x;
            wv[c + 1] = v.y;
            wv[c + 2] = v.z;
            wv[c + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) wv[c] = wr[kk * NC + c];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0   ? hv[i].x
                          : kk == 1 ? hv[i].y
                          : kk == 2 ? hv[i].z
                                    : hv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a, wv[c], acc[i][c]);
        }
      }
    }
  }
  // the partial sums over this warp's own ring: [8 k-splits][kPassG][NC]
  // (every copy has landed: the groups still pending are empty)
  __syncwarp();
  float* red = ring + ks * kPassG * NC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = red + (rg + 4 * i) * NC;
    if constexpr (NC % 4 == 0) {
#pragma unroll
      for (int c = 0; c < NC; c += 4)
        *reinterpret_cast<float4*>(row + c) = make_float4(
            acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) row[c] = acc[i][c];
    }
  }
}

// Column c of tile row r of the product, summed over the block's 64
// k-splits' partial sums (after a block barrier).
template <int NC>
__device__ __forceinline__ float gru_total(const float* smem, int slot, int r,
                                           int c) {
  float s = 0.f;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp)
#pragma unroll
    for (int sp = 0; sp < 8; ++sp)
      s += smem[wp * kNS * slot + (sp * kPassG + r) * NC + c];
  return s;
}

// K6. UG units a column group (1, 2 or 4), `groups` column groups a block;
// w_rel null where the block's gate columns of w are kept in shared
// memory, else the relaid copy [gridDim.x][groups][HP][3 UG] they are
// streamed from (UG = 4 only). buf [3][B][HP] zeroed by the caller: h, r h
// and z (columns H..HP-1 of h and r h stay 0).
template <int UG, typename E>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_kernel(const E* __restrict__ x, const E* __restrict__ w,
               const float* __restrict__ w_rel, const E* __restrict__ h0,
               const int* __restrict__ seqlen, int B, int T, int H, int HP,
               int groups, int reverse, E* __restrict__ hs,
               E* __restrict__ stash, float* buf,
               unsigned int* arrived) {
  constexpr int NA = 2 * UG;   // phase A's gate columns of a group: r | z
  constexpr int NB = UG;       // phase B's: the candidate
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const bool stream_w = w_rel != nullptr;
  const int slot = gru_slot_floats(UG, stream_w);
  float* ring = smem + warp * kNS * slot;
  float* wa_s = smem + kWarps * kNS * slot;        // [groups] r | z columns
  float* wb_s = wa_s + groups * gru_wrow(NA, HP);  // [groups] c columns
  const int U = UG * groups;
  const int j0 = blockIdx.x * U;
  // buf[0]: h, read in phase A (and in phase B by the thread that then
  // writes the unit's new h); buf[1]: r h, from phase A to phase B;
  // buf[2]: z of the owned units, from phase A to phase B
  const size_t bhp = (size_t)B * HP;
  float* hbuf = buf;
  float* rhbuf = buf + bhp;
  float* zbuf = buf + 2 * bhp;
  // this warp's share of k: [kb, ke)
  const int kw = ((HP / 4 + kWarps - 1) / kWarps) * 4;
  const int kb = min(HP, warp * kw);
  const int ke = min(HP, kb + kw);
  const size_t wgrp = (size_t)HP * 3 * UG;   // floats of a group in w_rel
  const float* w_blk =
      stream_w ? w_rel + (size_t)blockIdx.x * groups * wgrp : nullptr;

  if (!stream_w) {
    for (int p = threadIdx.x; p < groups * HP * 3 * UG; p += kThreads) {
      const int cg = p / (HP * 3 * UG);
      const int k = (p / (3 * UG)) % HP;
      const int c = p % (3 * UG);
      const int j = j0 + cg * UG + c % UG;
      const float v =
          (k < H && j < H)
              ? ld_f(w + (size_t)k * 3 * H + (size_t)(c / UG) * H + j)
              : 0.f;
      if (c < NA)
        wa_s[cg * gru_wrow(NA, HP) + gru_wrow(NA, k) + c] = v;
      else
        wb_s[cg * gru_wrow(NB, HP) + gru_wrow(NB, k) + c - NA] = v;
    }
  }
  for (int p = threadIdx.x; p < B * U; p += kThreads) {
    const int b = p / U;
    const int j = j0 + p % U;
    if (j < H) hbuf[(size_t)b * HP + j] = ld_f(h0 + (size_t)b * H + j);
  }
  unsigned int target = 0;
  grid_sync(arrived, target);

  const int tiles = ((B + kPassG - 1) / kPassG) * groups;
  for (int t = 0; t < T; ++t) {
    const int tpos = reverse ? T - 1 - t : t;
    // phase A: r and z of the owned units; thread (row, gate column)
    for (int tile = 0; tile < tiles; ++tile) {
      const int row0 = (tile / groups) * kPassG;
      const int cg = tile % groups;
      const int pr = threadIdx.x / NA, pc = threadIdx.x % NA;
      const int gate = pc / UG;   // 0: r, 1: z
      const int b = row0 + pr, j = j0 + cg * UG + pc % UG;
      const bool mine = pr < kPassG && b < B && j < H;
      const size_t xo = ((size_t)b * T + t) * 3 * H + (size_t)gate * H + j;
      float xg = 0.f, hprev = 0.f;
      if (mine) {   // in flight while the product runs
        xg = ld_f(x + xo);
        if (gate == 0) hprev = __ldcg(hbuf + (size_t)b * HP + j);
      }
      float acc[8][NA];
      gru_product<NA>(acc, hbuf, B, HP, row0, kb, ke, ring, slot,
                      wa_s + cg * gru_wrow(NA, HP),
                      stream_w ? w_blk + cg * wgrp : nullptr, 3 * UG);
      __syncthreads();
      if (mine) {
        const float g = sigmoid_f(xg + gru_total<NA>(smem, slot, pr, pc));
        if (gate == 0)
          rhbuf[(size_t)b * HP + j] = g * hprev;
        else
          zbuf[(size_t)b * HP + j] = g;
        if (stash != nullptr) st_e(stash + xo, g);
      }
      __syncthreads();  // the rings are free for the next tile's pieces
    }
    grid_sync(arrived, target);   // r h of every unit is out
    // phase B: the candidate over every unit's r h, then the new h;
    // thread (row, unit)
    for (int tile = 0; tile < tiles; ++tile) {
      const int row0 = (tile / groups) * kPassG;
      const int cg = tile % groups;
      const int pr = threadIdx.x / NB, pu = threadIdx.x % NB;
      const int b = row0 + pr, j = j0 + cg * UG + pu;
      const bool mine = pr < kPassG && b < B && j < H;
      const size_t xo = ((size_t)b * T + t) * 3 * H + 2 * (size_t)H + j;
      float xc = 0.f, zg = 0.f, hprev = 0.f;
      int len = 0;
      if (mine) {   // in flight while the product runs
        xc = ld_f(x + xo);
        zg = __ldcg(zbuf + (size_t)b * HP + j);
        hprev = __ldcg(hbuf + (size_t)b * HP + j);
        len = seqlen[b];
      }
      float acc[8][NB];
      gru_product<NB>(acc, rhbuf, B, HP, row0, kb, ke, ring, slot,
                      wb_s + cg * gru_wrow(NB, HP),
                      stream_w ? w_blk + cg * wgrp + NA : nullptr, 3 * UG);
      __syncthreads();
      if (mine) {
        const float cgate = tanhf(xc + gru_total<NB>(smem, slot, pr, pu));
        // the carried h in E
        float hn = round_to<E>(zg * hprev + (1.f - zg) * cgate);
        if (len <= tpos) hn = hprev;
        hbuf[(size_t)b * HP + j] = hn;
        st_e(hs + ((size_t)b * T + t) * H + j, hn);
        if (stash != nullptr) st_e(stash + xo, cgate);
      }
      __syncthreads();  // the rings are free for the next tile's pieces
    }
    grid_sync(arrived, target);   // the new h of every unit is out
  }
}

// --- launch ---------------------------------------------------------------

struct Device {
  int sms = 0, smem_max = 0, coop = 0;
};

cudaError_t device_info(Device* d) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&d->coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&d->smem_max,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cudaSuccess;
}

// How a kernel covers H hidden units: `ug` units a column group, `groups`
// groups a block, `blocks` blocks (no more than the SMs), w read from the
// relaid copy where `stream_w`, `smem` bytes of dynamic shared memory, h
// buffer rows of `hp` floats.
struct Plan {
  int ug, groups, blocks, stream_w;
  size_t smem;
  int hp;
};

// The fewest units a block (1, 2, 4, then multiples of `step`) that need no
// more blocks than SMs.
int units_per_block(int H, int sms, int step) {
  for (int u = 1; u < step; u *= 2)
    if ((H + u - 1) / u <= sms) return u;
  const int per_sm = (H + sms - 1) / sms;
  return ((per_sm + step - 1) / step) * step;
}

Plan lstm_plan(int H, const Device& d) {
  Plan p{};
  const int U = units_per_block(H, d.sms, 4);
  p.ug = U < 4 ? U : 4;
  p.groups = U / p.ug;
  p.blocks = (H + U - 1) / U;
  p.hp = (H + 3) / 4 * 4;
  const size_t rings = (size_t)kWarps * kNS * lstm_slot_floats(4 * p.ug, false);
  const size_t resident = (size_t)p.groups * p.hp * 4 * p.ug;
  p.stream_w = (rings + resident) * sizeof(float) > (size_t)d.smem_max;
  p.smem = (p.stream_w ? (size_t)kWarps * kNS *
                             lstm_slot_floats(4 * p.ug, true)
                       : rings + resident) *
           sizeof(float);
  return p;
}

Plan gru_plan(int H, const Device& d) {
  Plan p{};
  const int U = units_per_block(H, d.sms, 4);
  p.ug = U < 4 ? U : 4;
  p.groups = U / p.ug;
  p.blocks = (H + U - 1) / U;
  p.hp = (H + 3) / 4 * 4;
  const size_t rings = (size_t)kWarps * kNS * gru_slot_floats(p.ug, false);
  const size_t resident = (size_t)p.groups * (gru_wrow(2 * p.ug, p.hp) +
                                              gru_wrow(p.ug, p.hp));
  p.stream_w = (rings + resident) * sizeof(float) > (size_t)d.smem_max;
  p.smem = (p.stream_w ? (size_t)kWarps * kNS * gru_slot_floats(p.ug, true)
                       : rings + resident) *
           sizeof(float);
  return p;
}

// Cooperative launch of `kern` on `grid` blocks, one on each SM at most.
template <typename K>
cudaError_t coop_launch(K kern, int grid, size_t smem, void** args,
                        cudaStream_t stream, const Device& d) {
  if (!d.coop) return cudaErrorNotSupported;
  if (grid > d.sms || smem > (size_t)d.smem_max) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The LSTM kernel for `p.ug` units a column group over element type E.
template <typename E>
cudaError_t launch_lstm(const Plan& p, void** args, cudaStream_t s,
                        const Device& d) {
  switch (p.ug) {
    case 1: return coop_launch(lstm_seq_kernel<1, E>, p.blocks, p.smem, args, s, d);
    case 2: return coop_launch(lstm_seq_kernel<2, E>, p.blocks, p.smem, args, s, d);
    case 4: return coop_launch(lstm_seq_kernel<4, E>, p.blocks, p.smem, args, s, d);
    default: return cudaErrorInvalidValue;
  }
}

// The GRU kernel for `p.ug` units a column group over element type E.
template <typename E>
cudaError_t launch_gru(const Plan& p, void** args, cudaStream_t s,
                       const Device& d) {
  switch (p.ug) {
    case 1: return coop_launch(gru_seq_kernel<1, E>, p.blocks, p.smem, args, s, d);
    case 2: return coop_launch(gru_seq_kernel<2, E>, p.blocks, p.smem, args, s, d);
    case 4: return coop_launch(gru_seq_kernel<4, E>, p.blocks, p.smem, args, s, d);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan of the LSTM (kind 0) or the GRU (kind 1) kernel for B
// rows of H units on the current device: out = {units a column group,
// column groups a block, blocks, 1 where w is read from the relaid copy,
// dynamic shared memory bytes, row stride of the h buffer}.
int ptt_recurrent_plan(int kind, int B, int H, int* out) {
  if (B < 1 || H < 1) return cudaErrorInvalidValue;
  Device d;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  const Plan p = kind == 0 ? lstm_plan(H, d) : gru_plan(H, d);
  out[0] = p.ug;
  out[1] = p.groups;
  out[2] = p.blocks;
  out[3] = p.stream_w;
  out[4] = (int)p.smem;
  out[5] = p.hp;
  return cudaSuccess;
}

// x [B,T,4H], w [H,4H], h0/c0 [B,H] contiguous, of element type `dtype`
// (kF32 or kBF16), as are hs, cs [B,T,H] and stash [B,T,4H] (or null);
// w_rel the float32 relaid copy of w where the plan streams w, else null;
// seqlen [B] int32; hbuf [2,B,HP] float32 scratch, zeroed; arrived: one
// zeroed unsigned int. Returns the launch's cudaError_t; launches on
// `stream` and does not synchronize.
int ptt_lstm_seq(const void* x, const void* w, const void* w_rel,
                 const void* h0, const void* c0, const void* seqlen, int B,
                 int T, int H, int reverse, int dtype, void* hs, void* cs,
                 void* stash, void* hbuf, void* arrived, void* stream) {
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  Device d;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  const Plan p = lstm_plan(H, d);
  if (p.stream_w != (w_rel != nullptr) || p.smem > (size_t)d.smem_max)
    return cudaErrorInvalidValue;
  const float* wr = static_cast<const float*>(w_rel);
  const int* sl = static_cast<const int*>(seqlen);
  float* hb = static_cast<float*>(hbuf);
  unsigned int* ar = static_cast<unsigned int*>(arrived);
  int hp = p.hp, groups = p.groups;
  void* args[] = {&x, &w, &wr, &h0, &c0, &sl, &B, &T, &H, &hp,
                  &groups, &reverse, &hs, &cs, &stash, &hb, &ar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    e = launch_lstm<float>(p, args, s, d);
  else if (dtype == kBF16)
    e = launch_lstm<__nv_bfloat16>(p, args, s, d);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// x [B,T,3H], w [H,3H], h0 [B,H] contiguous, of element type `dtype`, as
// are hs [B,T,H] and stash [B,T,3H] (or null); w_rel the float32 relaid
// copy of w where the plan streams w, else null; seqlen [B] int32; buf
// [3,B,HP] float32 scratch, zeroed; arrived: one zeroed unsigned int.
int ptt_gru_seq(const void* x, const void* w, const void* w_rel,
                const void* h0, const void* seqlen, int B, int T, int H,
                int reverse, int dtype, void* hs, void* stash, void* buf,
                void* arrived, void* stream) {
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  Device d;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  const Plan p = gru_plan(H, d);
  if (p.stream_w != (w_rel != nullptr) || p.smem > (size_t)d.smem_max ||
      (p.stream_w && p.ug != 4))
    return cudaErrorInvalidValue;
  const float* wr = static_cast<const float*>(w_rel);
  const int* sl = static_cast<const int*>(seqlen);
  float* bf = static_cast<float*>(buf);
  unsigned int* ar = static_cast<unsigned int*>(arrived);
  int hp = p.hp, groups = p.groups;
  void* args[] = {&x, &w, &wr, &h0, &sl, &B, &T, &H, &hp, &groups,
                  &reverse, &hs, &stash, &bf, &ar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    e = launch_gru<float>(p, args, s, d);
  else if (dtype == kBF16)
    e = launch_gru<__nv_bfloat16>(p, args, s, d);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
