// Whole-sequence LSTM and GRU recurrences for Hopper (sm_90a): every time
// step of one sequence batch in a single launch.
//
// Replaces paddle_tpu/fusion/recurrent.py:_lstm_seq_kernel (LSTM, K5) and
// _gru_seq_kernel (GRU, K6), both driven by _pallas_seq. They compute what
// those kernels compute, in float32:
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
// bound it, with T grid barriers (2T for the GRU) as a serial floor beside.
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
// What a step still spends, by part (the product, the staging of h, where
// every SM reads all of h from L2 each step, and the barrier), is measured
// by probe_recurrent.py; PERF.md has its numbers.
//
// K6 (gru_seq_kernel) keeps its first design: batch rows ride the 32 lanes
// of a warp, the 8 warps split k, h is staged through shared memory 128
// columns at a time, and the warps' partial sums are added in shared memory.
// Beyond 8 units a block it loops over groups of 8 units, and a w slice too
// large for shared memory is read through L2 from a copy laid out
// [block][group][H][24].
//
// Launch: ptt_recurrent_plan picks the units a block so that the blocks are
// no more than the SMs, one block on each; cudaLaunchCooperativeKernel
// guarantees they are co-resident, which the barrier needs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K6's row tiles (and row_tile_product's)
constexpr int kRows = 32;                  // batch rows per tile: one a lane
constexpr int kChunk = 128;                // columns of h staged at once
constexpr int kPerWarp = kChunk / kWarps;  // of which each warp takes 16
constexpr int kLd = kChunk + 1;            // padded staged row: no conflicts
constexpr int kStage = kRows * kChunk / kThreads;  // staged values a thread

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
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

// One row tile of K6's recurrent product: for batch rows
// row0 .. row0 + 31 (row0 + lane for this thread) and NC columns starting at
// C0 of the block's w slice w_s ([H][LDW], in shared memory or the relaid
// copy in global memory), each warp sums
// its share of k; the partial sums land in red[warp][lane][c], and the block
// synchronizes before returning so that the caller may add them up.
// src is [B, H] in global memory, written by other blocks in this launch.
template <int NC, int LDW, int C0>
__device__ __forceinline__ void row_tile_product(
    const float* src, int B, int H, int row0, const float* __restrict__ w_s,
    float* __restrict__ h_s, float* __restrict__ red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kChunk) {
    // every load of the chunk is in flight at once, and before the
    // barrier: one L2 latency a chunk, not one a load
    float v[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int b = row0 + p / kChunk;
      const int k = k0 + p % kChunk;
      v[i] = (b < B && k < H) ? __ldcg(src + (size_t)b * H + k) : 0.f;
    }
    __syncthreads();  // the previous chunk's (or tile's) readers are done
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int p = threadIdx.x + i * kThreads;
      h_s[(p / kChunk) * kLd + p % kChunk] = v[i];
    }
    __syncthreads();
    const int kb = warp * kPerWarp;
    const int kn = min(kPerWarp, H - k0 - kb);
    for (int kk = 0; kk < kn; ++kk) {
      const float hv = h_s[lane * kLd + kb + kk];
      const float* wr = w_s + (size_t)(k0 + kb + kk) * LDW + C0;
      if constexpr (NC % 4 == 0 && LDW % 4 == 0 && C0 % 4 == 0) {
#pragma unroll
        for (int c = 0; c < NC; c += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + c);
          acc[c] = fmaf(hv, wv.x, acc[c]);
          acc[c + 1] = fmaf(hv, wv.y, acc[c + 1]);
          acc[c + 2] = fmaf(hv, wv.z, acc[c + 2]);
          acc[c + 3] = fmaf(hv, wv.w, acc[c + 3]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(hv, wr[c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) red[(warp * kRows + lane) * NC + c] = acc[c];
  __syncthreads();
}

// The (tile row, owned unit) pair a thread updates after a row tile's
// product: thread r * U + u takes row row0 + r and unit j0 + u; `mine` is
// false for threads beyond kRows * U and for pairs past B or H.
struct TilePair {
  int r, u, b, j;
  bool mine;
};

template <int U>
__device__ __forceinline__ TilePair tile_pair(int row0, int j0, int B,
                                              int H) {
  static_assert(kRows * U <= kThreads, "one pair a thread at most");
  TilePair q;
  q.r = threadIdx.x / U;
  q.u = threadIdx.x - q.r * U;
  q.b = row0 + q.r;
  q.j = j0 + q.u;
  q.mine = threadIdx.x < kRows * U && q.b < B && q.j < H;
  return q;
}

// The sum over warps of column c for tile row r.
template <int NC>
__device__ __forceinline__ float warp_total(const float* red, int r, int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + r) * NC + c];
  return s;
}

// Load the block's gate columns of w ([H][NG * H] row-major) into w_s
// ([H][NG * U]): column g * U + u holds gate g of unit j0 + u (zeros past H).
template <int NG, int U>
__device__ void load_w_slice(const float* __restrict__ w, int H, int j0,
                             float* __restrict__ w_s) {
  constexpr int NC = NG * U;
  for (int p = threadIdx.x; p < H * NC; p += kThreads) {
    const int k = p / NC;
    const int c = p - k * NC;
    const int g = c / U;
    const int j = j0 + c - g * U;
    w_s[p] = j < H ? w[(size_t)k * NG * H + (size_t)g * H + j] : 0.f;
  }
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
template <int UG>
__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ w_rel,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ seqlen, int B, int T, int H, int HP,
                int groups, int reverse, float* __restrict__ hs,
                float* __restrict__ cs, float* __restrict__ stash,
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
                   ? w[(size_t)k * 4 * H + (size_t)(c / UG) * H + j]
                   : 0.f;
    }
  }
  for (int p = threadIdx.x; p < B * U; p += kThreads) {
    const int b = p / U;
    const int j = j0 + p % U;
    if (j < H) hbuf[(size_t)b * HP + j] = h0[(size_t)b * H + j];
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
        for (int g = 0; g < 4; ++g) xg[g] = x[xo + (size_t)g * H];
        hprev = hcur[(size_t)b * HP + j];
        cprev = t == 0 ? c0[(size_t)b * H + j]
                       : cs[((size_t)b * T + t - 1) * H + j];
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
        float cn = fg * cprev + ig * gg;
        float hn = og * tanhf(cn);
        if (seqlen[b] <= tpos) {
          cn = cprev;
          hn = hprev;
        }
        hnxt[(size_t)b * HP + j] = hn;
        const size_t so = ((size_t)b * T + t) * H + j;
        hs[so] = hn;
        cs[so] = cn;
        if (stash != nullptr) {
          stash[xo] = ig;
          stash[xo + H] = fg;
          stash[xo + 2 * H] = gg;
          stash[xo + 3 * H] = og;
        }
      }
      __syncthreads();  // the rings are free for the next tile's pieces
    }
    grid_sync(arrived, target);
  }
}

// --- K6: the GRU ----------------------------------------------------------

// Shared memory of K6: the w slices where resident ([groups][H][3U]), one
// staged row tile of h, the warps' partial sums, h, r and z of the owned
// units ([B][U groups] each).
size_t gru_smem_bytes(int U, int groups, bool stream_w, int B, int H) {
  return ((stream_w ? 0 : (size_t)groups * H * 3 * U) + kRows * kLd +
          (size_t)kWarps * kRows * 2 * U + 3 * (size_t)B * U * groups) *
         sizeof(float);
}

// K6. U units a group (1, 2, 4 or 8), `groups` groups a block; w_rel null
// where the w slices are resident in shared memory, else the relaid copy
// [gridDim.x][groups][H][3U] they are read from through L2.
template <int U, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ w_rel,
               const float* __restrict__ h0, const int* __restrict__ seqlen,
               int B, int T, int H, int groups, int reverse,
               float* __restrict__ hs, float* __restrict__ stash, float* buf,
               unsigned int* arrived) {
  constexpr int NC = 3 * U;
  extern __shared__ __align__(16) float smem[];
  const int UT = U * groups;                  // units of the block
  float* w_s = smem;                          // [groups][H][NC]: r | z | c
  float* h_s = w_s + (STREAM ? 0 : (size_t)groups * H * NC);  // [kRows][kLd]
  float* red = h_s + kRows * kLd;             // [kWarps][kRows][2U]
  float* h_own = red + kWarps * kRows * 2 * U;  // [B][UT]
  float* r_own = h_own + (size_t)B * UT;      // [B][UT]
  float* z_own = r_own + (size_t)B * UT;      // [B][UT]
  const int j0 = blockIdx.x * UT;
  // buf[0]: h, read in phase A and written in phase B of each step (all
  // reads precede the middle barrier, all writes follow it); buf[1]: r h.
  float* hbuf = buf;
  float* rhbuf = buf + (size_t)B * H;

  if (!STREAM) {
    for (int cg = 0; cg < groups; ++cg)
      load_w_slice<3, U>(w, H, j0 + cg * U, w_s + (size_t)cg * H * NC);
  }
  for (int p = threadIdx.x; p < B * UT; p += kThreads) {
    const int b = p / UT;
    const int j = j0 + p % UT;
    if (j < H) {
      h_own[p] = h0[(size_t)b * H + j];
      hbuf[(size_t)b * H + j] = h_own[p];
    }
  }
  unsigned int target = 0;
  grid_sync(arrived, target);

  for (int t = 0; t < T; ++t) {
    const int tpos = reverse ? T - 1 - t : t;
    // phase A: r, z of the owned units; publish r h
    for (int cg = 0; cg < groups; ++cg) {
      const float* w_g =
          STREAM ? w_rel + ((size_t)blockIdx.x * groups + cg) * H * NC
                 : w_s + (size_t)cg * H * NC;
      for (int row0 = 0; row0 < B; row0 += kRows) {
        const TilePair q = tile_pair<U>(row0, j0 + cg * U, B, H);
        const size_t xo = ((size_t)q.b * T + t) * 3 * H + q.j;
        float xr = 0.f, xz = 0.f;
        if (q.mine) {  // in flight while the product runs
          xr = x[xo];
          xz = x[xo + H];
        }
        row_tile_product<2 * U, NC, 0>(hbuf, B, H, row0, w_g, h_s, red);
        if (q.mine) {
          const int r = q.r, u = q.u, b = q.b, j = q.j;
          const float rg = sigmoid_f(xr + warp_total<2 * U>(red, r, u));
          const float zg = sigmoid_f(xz + warp_total<2 * U>(red, r, U + u));
          const int o = b * UT + cg * U + u;
          r_own[o] = rg;
          z_own[o] = zg;
          rhbuf[(size_t)b * H + j] = rg * h_own[o];
        }
      }
    }
    grid_sync(arrived, target);
    // phase B: the candidate over every unit's r h, then the new h
    for (int cg = 0; cg < groups; ++cg) {
      const float* w_g =
          STREAM ? w_rel + ((size_t)blockIdx.x * groups + cg) * H * NC
                 : w_s + (size_t)cg * H * NC;
      for (int row0 = 0; row0 < B; row0 += kRows) {
        const TilePair q = tile_pair<U>(row0, j0 + cg * U, B, H);
        const size_t xo = ((size_t)q.b * T + t) * 3 * H + q.j;
        const float xc = q.mine ? x[xo + 2 * H] : 0.f;
        row_tile_product<U, NC, 2 * U>(rhbuf, B, H, row0, w_g, h_s, red);
        if (q.mine) {
          const int r = q.r, u = q.u, b = q.b, j = q.j;
          const float cgate = tanhf(xc + warp_total<U>(red, r, u));
          const int o = b * UT + cg * U + u;
          const float zg = z_own[o];
          const float hp = h_own[o];
          float hn = zg * hp + (1.f - zg) * cgate;
          if (seqlen[b] <= tpos) hn = hp;
          h_own[o] = hn;
          hs[((size_t)b * T + t) * H + j] = hn;
          if (stash != nullptr) {
            stash[xo] = r_own[o];
            stash[xo + H] = zg;
            stash[xo + 2 * H] = cgate;
          }
          hbuf[(size_t)b * H + j] = hn;
        }
      }
    }
    grid_sync(arrived, target);
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

Plan gru_plan(int B, int H, const Device& d) {
  Plan p{};
  const int U = units_per_block(H, d.sms, 8);
  p.ug = U < 8 ? U : 8;
  p.groups = U / p.ug;
  p.blocks = (H + U - 1) / U;
  p.hp = H;
  p.stream_w =
      gru_smem_bytes(p.ug, p.groups, false, B, H) > (size_t)d.smem_max;
  p.smem = gru_smem_bytes(p.ug, p.groups, p.stream_w, B, H);
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

template <int U>
cudaError_t launch_gru(bool stream_w, int blocks, size_t smem, void** args,
                       cudaStream_t s, const Device& d) {
  return stream_w ? coop_launch(gru_seq_kernel<U, true>, blocks, smem, args,
                                s, d)
                  : coop_launch(gru_seq_kernel<U, false>, blocks, smem, args,
                                s, d);
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan of the LSTM (kind 0) or the GRU (kind 1) kernel for B
// rows of H units on the current device: out = {units a column group,
// column groups a block, blocks, 1 where w is read from the relaid copy,
// dynamic shared memory bytes, row stride of the LSTM's h buffer}.
int ptt_recurrent_plan(int kind, int B, int H, int* out) {
  if (B < 1 || H < 1) return cudaErrorInvalidValue;
  Device d;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  const Plan p = kind == 0 ? lstm_plan(H, d) : gru_plan(B, H, d);
  out[0] = p.ug;
  out[1] = p.groups;
  out[2] = p.blocks;
  out[3] = p.stream_w;
  out[4] = (int)p.smem;
  out[5] = p.hp;
  return cudaSuccess;
}

// x [B,T,4H], w [H,4H], h0/c0 [B,H] float32 contiguous; w_rel the relaid
// copy of w where the plan streams w, else null; seqlen [B] int32;
// hs, cs [B,T,H]; stash [B,T,4H] or null; hbuf [2,B,HP] float32 scratch,
// zeroed; arrived: one zeroed unsigned int. Returns the launch's
// cudaError_t; launches on `stream` and does not synchronize.
int ptt_lstm_seq(const void* x, const void* w, const void* w_rel,
                 const void* h0, const void* c0, const void* seqlen, int B,
                 int T, int H, int reverse, void* hs, void* cs, void* stash,
                 void* hbuf, void* arrived, void* stream) {
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  Device d;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  const Plan p = lstm_plan(H, d);
  if (p.stream_w != (w_rel != nullptr) || p.smem > (size_t)d.smem_max)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* wr = static_cast<const float*>(w_rel);
  const float* h0f = static_cast<const float*>(h0);
  const float* c0f = static_cast<const float*>(c0);
  const int* sl = static_cast<const int*>(seqlen);
  float* hsf = static_cast<float*>(hs);
  float* csf = static_cast<float*>(cs);
  float* stf = static_cast<float*>(stash);
  float* hb = static_cast<float*>(hbuf);
  unsigned int* ar = static_cast<unsigned int*>(arrived);
  int hp = p.hp, groups = p.groups;
  void* args[] = {&xf, &wf, &wr, &h0f, &c0f, &sl, &B, &T, &H, &hp,
                  &groups, &reverse, &hsf, &csf, &stf, &hb, &ar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.ug) {
    case 1: e = coop_launch(lstm_seq_kernel<1>, p.blocks, p.smem, args, s, d); break;
    case 2: e = coop_launch(lstm_seq_kernel<2>, p.blocks, p.smem, args, s, d); break;
    case 4: e = coop_launch(lstm_seq_kernel<4>, p.blocks, p.smem, args, s, d); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// x [B,T,3H], w [H,3H], h0 [B,H] float32 contiguous; w_rel the relaid copy
// of w where the plan streams w, else null; seqlen [B] int32; hs [B,T,H];
// stash [B,T,3H] or null; buf [2,B,H] float32 scratch; arrived: one zeroed
// unsigned int.
int ptt_gru_seq(const void* x, const void* w, const void* w_rel,
                const void* h0, const void* seqlen, int B, int T, int H,
                int reverse, void* hs, void* stash, void* buf, void* arrived,
                void* stream) {
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  Device d;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  const Plan p = gru_plan(B, H, d);
  if (p.stream_w != (w_rel != nullptr) || p.smem > (size_t)d.smem_max)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* wr = static_cast<const float*>(w_rel);
  const float* h0f = static_cast<const float*>(h0);
  const int* sl = static_cast<const int*>(seqlen);
  float* hsf = static_cast<float*>(hs);
  float* stf = static_cast<float*>(stash);
  float* bf = static_cast<float*>(buf);
  unsigned int* ar = static_cast<unsigned int*>(arrived);
  int groups = p.groups;
  void* args[] = {&xf, &wf, &wr, &h0f, &sl, &B, &T, &H, &groups, &reverse,
                  &hsf, &stf, &bf, &ar};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.ug) {
    case 1: e = launch_gru<1>(p.stream_w, p.blocks, p.smem, args, s, d); break;
    case 2: e = launch_gru<2>(p.stream_w, p.blocks, p.smem, args, s, d); break;
    case 4: e = launch_gru<4>(p.stream_w, p.blocks, p.smem, args, s, d); break;
    case 8: e = launch_gru<8>(p.stream_w, p.blocks, p.smem, args, s, d); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
