// Hopper kernels for the two device DPs, called from JAX through XLA's FFI
// (ops/gpu_kernels.py builds this file with nvcc and registers the handlers).
//
//   SdChainDp      chain-DP forward (ops/chain_dp.chain_dp_forward): one
//                  block per read window, one warp per monomer row (or a few
//                  rows), the row's DP column in registers. Writes the
//                  per-position end-cell scores and block starts [B, W, M]
//                  that ops/chain_dp.block_walk consumes.
//   SdNwIdentity   NW (distance, columns) of the edlib-preferred co-optimal
//                  path (ops/identity.nw_identity_batch): one warp per pair,
//                  the query column in registers; pairwise or over the
//                  (query x target) cross product.
//
// Both DPs fold the within-column chain (deletions in the chain DP, "up"
// moves in NW) into a constant-offset prefix max / min that carries a
// payload and keeps the EARLIER cell on ties — the landing cell of the
// reference's backward walk (see ops/chain_dp.py and ops/identity.py for the
// derivation). Each thread holds CPT consecutive cells of the column: a
// sequential scan over its own cells, a __shfl_up_sync scan over the 32
// lanes' totals, then one combine. All state is int32 and every result is
// bit-identical to the lax.scan programs.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kNeg = -(1 << 30);  // ops/chain_dp.NEG
constexpr int8_t kMonoPad = 5;        // io/fasta PAD_CODE
constexpr int32_t kNoChar = -1000;    // never equals a target code

// Inclusive prefix max of t over the warp's 32*CPT cells, payload p riding
// along; ties keep the earlier cell.
template <int CPT>
__device__ __forceinline__ void warp_prefix_max(int32_t (&t)[CPT],
                                                int32_t (&p)[CPT], int lane) {
#pragma unroll
  for (int s = 1; s < CPT; ++s) {
    if (t[s - 1] >= t[s]) {
      t[s] = t[s - 1];
      p[s] = p[s - 1];
    }
  }
  int32_t rt = t[CPT - 1], rp = p[CPT - 1];
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int32_t ot = __shfl_up_sync(kFull, rt, off);
    const int32_t op = __shfl_up_sync(kFull, rp, off);
    if (lane >= off && ot >= rt) {
      rt = ot;
      rp = op;
    }
  }
  const int32_t et = __shfl_up_sync(kFull, rt, 1);
  const int32_t ep = __shfl_up_sync(kFull, rp, 1);
  if (lane > 0) {
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      if (et >= t[s]) {
        t[s] = et;
        p[s] = ep;
      }
    }
  }
}

// Inclusive prefix min, ties keep the earlier cell.
template <int CPT>
__device__ __forceinline__ void warp_prefix_min(int32_t (&t)[CPT],
                                                int32_t (&p)[CPT], int lane) {
#pragma unroll
  for (int s = 1; s < CPT; ++s) {
    if (t[s - 1] <= t[s]) {
      t[s] = t[s - 1];
      p[s] = p[s - 1];
    }
  }
  int32_t rt = t[CPT - 1], rp = p[CPT - 1];
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int32_t ot = __shfl_up_sync(kFull, rt, off);
    const int32_t op = __shfl_up_sync(kFull, rp, off);
    if (lane >= off && ot <= rt) {
      rt = ot;
      rp = op;
    }
  }
  const int32_t et = __shfl_up_sync(kFull, rt, 1);
  const int32_t ep = __shfl_up_sync(kFull, rp, 1);
  if (lane > 0) {
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      if (et <= t[s]) {
        t[s] = et;
        p[s] = ep;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Chain DP (reference: src/main.cpp:151-208; scan form: ops/chain_dp.py)
// ---------------------------------------------------------------------------

struct ChainArgs {
  const int8_t* windows;     // [B, W], READ_PAD-padded
  const int8_t* mono;        // [M, L] or [B, M, L], PAD_CODE-padded
  const int32_t* mono_lens;  // [M] or [B, M]
  int32_t* end;              // [B, W, M] score of each row's end cell
  int32_t* spend;            // [B, W, M] block start of that cell
  int W, M, L, per_window;
  int32_t ins, del, mismatch, match;
};

// Writes row j's end cell (k = len - 1) of position i, and stages the score
// in shared memory for the next position's chain max.
template <int CPT>
__device__ __forceinline__ void emit_end(const ChainArgs& a, int b, int i,
                                         int j, int len, int lane,
                                         const int32_t (&dp)[CPT],
                                         const int32_t (&sp)[CPT],
                                         int32_t* endv) {
  const size_t o = ((size_t)b * a.W + i) * a.M + j;
  if (len <= 0) {  // dropped row of an --ed_thr window: never an end cell
    if (lane == 0) {
      a.end[o] = kNeg;
      a.spend[o] = 0;
      endv[j] = kNeg;
    }
    return;
  }
  const int ke = len - 1;
  if (lane == ke / CPT) {
    const int slot = ke % CPT;
    int32_t v = dp[0], s = sp[0];
#pragma unroll
    for (int c = 1; c < CPT; ++c) {
      if (slot == c) {
        v = dp[c];
        s = sp[c];
      }
    }
    a.end[o] = v;
    a.spend[o] = s;
    endv[j] = v;
  }
}

__device__ __forceinline__ int32_t chain_max(const int32_t* endv, int M,
                                             int lane) {
  int32_t m = kNeg;
  for (int x = lane; x < M; x += kWarp) m = max(m, endv[x]);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

template <int CPT, int ROWS>
__global__ void __launch_bounds__(1024) chain_dp_kernel(ChainArgs a) {
  extern __shared__ int32_t smem[];
  int32_t* endv = smem;                                   // [2][M]
  int8_t* rc = reinterpret_cast<int8_t*>(smem + 2 * a.M);  // [W] read chars
  const int b = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int x = threadIdx.x; x < a.W; x += blockDim.x)
    rc[x] = a.windows[(size_t)b * a.W + x];
  const int8_t* mono = a.mono + (a.per_window ? (size_t)b * a.M * a.L : 0);
  const int32_t* lens = a.mono_lens + (a.per_window ? (size_t)b * a.M : 0);

  const int k0 = lane * CPT;
  int32_t mc[ROWS][CPT], dp[ROWS][CPT], sp[ROWS][CPT];
  int row_len[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int j = warp + r * nwarps;
    row_len[r] = j < a.M ? lens[j] : 0;
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int k = k0 + s;
      mc[r][s] = (j < a.M && k < a.L) ? mono[(size_t)j * a.L + k] : kMonoPad;
    }
  }
  __syncthreads();

  // column i = 0 (src/main.cpp:171-182): no chain entry, every start is 0
  {
    const int32_t c0 = rc[0];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = warp + r * nwarps;
      if (j >= a.M) continue;  // warp-uniform
      int32_t t[CPT], p[CPT];
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int k = k0 + s;
        const int32_t mm = mc[r][s] == c0 ? a.match : a.mismatch;
        const int32_t cand = k == 0 ? mm : (k - 1) * a.del + mm;
        t[s] = cand - k * a.del;
        p[s] = 0;
      }
      warp_prefix_max<CPT>(t, p, lane);
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        dp[r][s] = t[s] + (k0 + s) * a.del;
        sp[r][s] = 0;
      }
      emit_end<CPT>(a, b, 0, j, row_len[r], lane, dp[r], sp[r], endv);
    }
  }
  __syncthreads();
  int32_t chain = chain_max(endv, a.M, lane);

  // positions 1..W-1 (src/main.cpp:183-208). endv is double-buffered: a
  // warp writes buffer i&1 only after every warp passed the barrier that
  // ends their reads of the same buffer two positions back.
  for (int i = 1; i < a.W; ++i) {
    const int32_t c = rc[i];
    int32_t* ev = endv + (i & 1) * a.M;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = warp + r * nwarps;
      if (j >= a.M) continue;  // warp-uniform
      // previous column at k-1 for this thread's first cell
      const int32_t up_dp = __shfl_up_sync(kFull, dp[r][CPT - 1], 1);
      const int32_t up_sp = __shfl_up_sync(kFull, sp[r][CPT - 1], 1);
      int32_t t[CPT], p[CPT];
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        const int k = k0 + s;
        const int32_t pd = s == 0 ? up_dp : dp[r][s - 1];
        const int32_t ps = s == 0 ? up_sp : sp[r][s - 1];
        const int32_t mm = mc[r][s] == c ? a.match : a.mismatch;
        const int32_t kdel = k * a.del;
        const int32_t enter = chain + mm + kdel;
        const int32_t diag = k == 0 ? kNeg : pd + mm;
        const int32_t insv = dp[r][s] + a.ins;  // unguarded at k == 0
        const int32_t cand = max(enter, max(diag, k == 0 ? kNeg : insv));
        // start pointer in the reference's check order: ins, diag, enter
        // (src/main.cpp:245-257); at landing cells dp == cand
        t[s] = cand - kdel;
        p[s] = cand == insv ? sp[r][s] : (cand == diag ? ps : i);
      }
      warp_prefix_max<CPT>(t, p, lane);
#pragma unroll
      for (int s = 0; s < CPT; ++s) {
        dp[r][s] = t[s] + (k0 + s) * a.del;
        sp[r][s] = p[s];
      }
      emit_end<CPT>(a, b, i, j, row_len[r], lane, dp[r], sp[r], ev);
    }
    __syncthreads();
    chain = chain_max(ev, a.M, lane);
  }
}

template <int CPT, int ROWS>
cudaError_t launch_chain(cudaStream_t stream, const ChainArgs& a, int B) {
  const int nwarps = (a.M + ROWS - 1) / ROWS;
  const size_t smem = 2 * sizeof(int32_t) * a.M + ((a.W + 15) / 16) * 16;
  chain_dp_kernel<CPT, ROWS><<<B, nwarps * kWarp, smem, stream>>>(a);
  return cudaGetLastError();
}

// (CPT, ROWS) instantiations; ops/gpu_kernels.CHAIN_CONFIGS lists the same.
#define SD_CHAIN_CONFIGS(X)                                               \
  X(2, 1) X(4, 1) X(6, 1) X(8, 1) X(12, 1) X(16, 1) X(2, 2) X(4, 2) X(6, 2) \
      X(8, 2) X(12, 2) X(2, 4) X(4, 4) X(6, 4)

ffi::Error ChainDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> windows,
                       ffi::Buffer<ffi::S8> mono,
                       ffi::Buffer<ffi::S32> mono_lens,
                       ffi::ResultBuffer<ffi::S32> end,
                       ffi::ResultBuffer<ffi::S32> spend, int32_t ins,
                       int32_t dele, int32_t mismatch, int32_t match,
                       int32_t cpt, int32_t rows) {
  const auto wd = windows.dimensions();
  const auto md = mono.dimensions();
  if (wd.size() != 2 || (md.size() != 2 && md.size() != 3))
    return ffi::Error::InvalidArgument("sd_chain_dp: bad operand ranks");
  ChainArgs a;
  a.windows = windows.typed_data();
  a.mono = mono.typed_data();
  a.mono_lens = mono_lens.typed_data();
  a.end = end->typed_data();
  a.spend = spend->typed_data();
  const int B = static_cast<int>(wd[0]);
  a.W = static_cast<int>(wd[1]);
  a.per_window = md.size() == 3;
  a.M = static_cast<int>(md[md.size() - 2]);
  a.L = static_cast<int>(md[md.size() - 1]);
  a.ins = ins;
  a.del = dele;
  a.mismatch = mismatch;
  a.match = match;
  if (B == 0 || a.W == 0 || a.M == 0) return ffi::Error::Success();
  if ((a.M + rows - 1) / rows > 32 || a.L > kWarp * cpt)
    return ffi::Error::InvalidArgument("sd_chain_dp: shape exceeds (cpt, rows)");
  if (2 * 4 * a.M + a.W > 48 * 1024)
    return ffi::Error::InvalidArgument("sd_chain_dp: window too wide");
  cudaError_t err = cudaErrorInvalidValue;
  bool found = false;
#define SD_CHAIN_CASE(C, R)                        \
  if (!found && cpt == C && rows == R) {           \
    found = true;                                  \
    err = launch_chain<C, R>(stream, a, B);        \
  }
  SD_CHAIN_CONFIGS(SD_CHAIN_CASE)
#undef SD_CHAIN_CASE
  if (!found)
    return ffi::Error::InvalidArgument("sd_chain_dp: no kernel for cpt=" +
                                       std::to_string(cpt) + " rows=" +
                                       std::to_string(rows));
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sd_chain_dp: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

// ---------------------------------------------------------------------------
// NW identity (reference: src/edlib.cpp:945-1144 traceback preference
// up > left > diagonal; scan form: ops/identity.nw_identity_batch)
// ---------------------------------------------------------------------------

struct NwArgs {
  const int8_t* q;         // [Pq, Lq]
  const int32_t* q_lens;   // [Pq]
  const int8_t* t;         // [Pt, Lt]
  const int32_t* t_lens;   // [Pt]
  int32_t* out;            // [P, 2]: (distance, columns) at (q_len, t_len)
  int P, Lq, Lt, n_targets;  // n_targets > 0: pair p = (p / n_t, p % n_t)
};

constexpr int kNwWarps = 8;  // pairs per block

template <int CPT>
__global__ void __launch_bounds__(kNwWarps * kWarp) nw_kernel(NwArgs a) {
  const int lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * kNwWarps + threadIdx.x / kWarp;
  if (p >= a.P) return;  // warp-uniform
  const int qi = a.n_targets ? p / a.n_targets : p;
  const int ti = a.n_targets ? p % a.n_targets : p;
  const int ql = a.q_lens[qi], tl = a.t_lens[ti];
  if (ql + 1 > kWarp * CPT || ql > a.Lq || tl > a.Lt) {
    if (lane == 0) {  // outside this instantiation: visible, never silent
      a.out[2 * (size_t)p] = -1;
      a.out[2 * (size_t)p + 1] = -1;
    }
    return;
  }
  const int8_t* qrow = a.q + (size_t)qi * a.Lq;
  const int8_t* trow = a.t + (size_t)ti * a.Lt;
  const int i0 = lane * CPT;
  int32_t qc[CPT], D[CPT], Ln[CPT];
#pragma unroll
  for (int s = 0; s < CPT; ++s) {
    const int i = i0 + s;  // row i holds query char i-1
    qc[s] = (i >= 1 && i <= ql) ? qrow[i - 1] : kNoChar;
    D[s] = i;  // column j = 0: D = i, columns = i
    Ln[s] = i;
  }
  for (int j = 1; j <= tl; ++j) {
    const int32_t tc = trow[j - 1];
    const int32_t up_d = __shfl_up_sync(kFull, D[CPT - 1], 1);
    const int32_t up_l = __shfl_up_sync(kFull, Ln[CPT - 1], 1);
    int32_t tv[CPT], lv[CPT];
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int i = i0 + s;
      int32_t cd, cl;
      if (i == 0) {  // boundary row: D = j, columns = j
        cd = j;
        cl = j;
      } else {
        const int32_t pd = s == 0 ? up_d : D[s - 1];
        const int32_t pl = s == 0 ? up_l : Ln[s - 1];
        const int32_t left = D[s] + 1;
        const int32_t diag = pd + (qc[s] == tc ? 0 : 1);
        const bool take_left = left <= diag;  // left before diagonal
        cd = take_left ? left : diag;
        cl = (take_left ? Ln[s] : pl) + 1;
      }
      tv[s] = cd - i;
      lv[s] = cl - i;
    }
    warp_prefix_min<CPT>(tv, lv, lane);  // the up chain, up first on ties
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      D[s] = tv[s] + i0 + s;
      Ln[s] = lv[s] + i0 + s;
    }
  }
  if (lane == ql / CPT) {
    const int slot = ql % CPT;
    int32_t d = D[0], l = Ln[0];
#pragma unroll
    for (int c = 1; c < CPT; ++c) {
      if (slot == c) {
        d = D[c];
        l = Ln[c];
      }
    }
    a.out[2 * (size_t)p] = d;
    a.out[2 * (size_t)p + 1] = l;
  }
}

template <int CPT>
cudaError_t launch_nw(cudaStream_t stream, const NwArgs& a) {
  const int blocks = (a.P + kNwWarps - 1) / kNwWarps;
  nw_kernel<CPT><<<blocks, kNwWarps * kWarp, 0, stream>>>(a);
  return cudaGetLastError();
}

// ops/gpu_kernels.NW_CPTS lists the same
#define SD_NW_CPTS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(10) X(12) X(16) X(24) X(32)

ffi::Error NwIdentityImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                          ffi::Buffer<ffi::S32> q_lens, ffi::Buffer<ffi::S8> t,
                          ffi::Buffer<ffi::S32> t_lens,
                          ffi::ResultBuffer<ffi::S32> out, int32_t cpt,
                          int32_t cross) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  const auto od = out->dimensions();
  if (qd.size() != 2 || td.size() != 2 || od.size() != 2 || od[1] != 2)
    return ffi::Error::InvalidArgument("sd_nw_identity: bad operand ranks");
  NwArgs a;
  a.q = q.typed_data();
  a.q_lens = q_lens.typed_data();
  a.t = t.typed_data();
  a.t_lens = t_lens.typed_data();
  a.out = out->typed_data();
  a.P = static_cast<int>(od[0]);
  a.Lq = static_cast<int>(qd[1]);
  a.Lt = static_cast<int>(td[1]);
  a.n_targets = cross ? static_cast<int>(td[0]) : 0;
  if (a.P == 0) return ffi::Error::Success();
  cudaError_t err = cudaErrorInvalidValue;
  bool found = false;
#define SD_NW_CASE(C)                   \
  if (!found && cpt == C) {             \
    found = true;                       \
    err = launch_nw<C>(stream, a);      \
  }
  SD_NW_CPTS(SD_NW_CASE)
#undef SD_NW_CASE
  if (!found)
    return ffi::Error::InvalidArgument("sd_nw_identity: no kernel for cpt=" +
                                       std::to_string(cpt));
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sd_nw_identity: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SdChainDp, ChainDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("ins")
                                  .Attr<int32_t>("dele")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("cpt")
                                  .Attr<int32_t>("rows"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(SdNwIdentity, NwIdentityImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("cpt")
                                  .Attr<int32_t>("cross"));
