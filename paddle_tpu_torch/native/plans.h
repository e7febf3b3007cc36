// The recurrent forwards' plans in C++, for the native runner's CUDA ops
// (torch_ops.cc), which pick them at the batch a package is run at.
//
// The same rules as kernels/lstm.py lstm_fwd_plan and fwd_plan (for
// float32 and for the bf16 form), and
// kernels/gru.py gru_fwd_plan, cluster_plan and grid_plan, from the shape
// alone and an H100 SXM's shared memory: tests/test_torch_aoti.py holds
// these equal to the Python plans over a grid of (B, H), through
// `aoti_run --plans`. No torch here: aoti_run includes it too.

#pragma once

#include <algorithm>
#include <cstdint>

namespace ptpu {

// an H100 SXM, the card the plans are derived for
constexpr int64_t kSms = 132;
constexpr int64_t kSmemPerSm = 228 * 1024;
constexpr int64_t kSmemPerBlock = 227 * 1024;
constexpr int64_t kSmemReservedPerBlock = 1024;
constexpr int64_t kThreads = 256;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// --- the LSTM forward (csrc/lstm_fwd.cu) ------------------------------------

constexpr int64_t kLstmUnits[3] = {16, 8, 4};
constexpr int64_t kLstmWarps = 8;
constexpr int64_t kLstmAllRowsUnits = 4;  // the first port's kernel
constexpr int64_t kLstmRows = 32;
constexpr int64_t kLstmNcol = 4 * kLstmAllRowsUnits;

// U units and R rows a block (R = 0: the first port's kernel of 4 units
// and every row), `blocks` of `smem` bytes each
struct LstmFwdPlan {
  int64_t U = 0, R = 0, blocks = 0, smem = 0;
};

inline int64_t lstm_all_rows_smem(int64_t H) {
  return 4 * ((kLstmNcol + kLstmRows) * (H + 4) + kLstmRows * kLstmNcol);
}

// kernels/lstm.py _fwd_smem_bytes: W as float, the row tile of the dtype
inline int64_t lstm_fwd_smem(int64_t H, int64_t U, int64_t R, bool bf16) {
  const int64_t ld = 4 * ((H / 4) | 1);
  const int64_t RT = kThreads / U;
  const int64_t tile = bf16 ? 2 * RT * 8 * ((H / 8) | 1) : 4 * RT * ld;
  return 4 * (4 * U * ld + kLstmWarps * RT * (4 * U + U / 2) + 2 * R * U) +
         tile;
}

inline bool lstm_unit_count(int64_t U) {
  return U == 16 || U == 8 || U == 4;
}

// kernels/lstm.py _fwd_fits
inline bool lstm_fwd_fits(int64_t B, int64_t H, int64_t U, int64_t R,
                          bool bf16, LstmFwdPlan* plan) {
  if (!(B >= 1 && lstm_unit_count(U) && H >= U && H % U == 0 && R >= 1 &&
        R % (kThreads / U) == 0 && !(bf16 && H % 8)))
    return false;
  const int64_t smem = lstm_fwd_smem(H, U, R, bf16);
  const int64_t blocks = H / U * ceil_div(B, R);
  if (smem > kSmemPerBlock || blocks > kSms) return false;
  *plan = {U, R, blocks, smem};
  return true;
}

// kernels/lstm.py _all_rows_plan
inline bool lstm_all_rows_plan(int64_t B, int64_t H, LstmFwdPlan* plan) {
  if (!(B >= 1 && H >= kLstmAllRowsUnits && H % kLstmAllRowsUnits == 0))
    return false;
  const int64_t smem = lstm_all_rows_smem(H);
  if (smem > kSmemPerBlock) return false;
  const int64_t per_sm = std::min<int64_t>(
      2048 / kThreads, kSmemPerSm / (smem + kSmemReservedPerBlock));
  if (H / kLstmAllRowsUnits > kSms * per_sm) return false;
  *plan = {kLstmAllRowsUnits, 0, H / kLstmAllRowsUnits, smem};
  return true;
}

// kernels/lstm.py _units_and_rows with _fwd_fits
inline bool lstm_units_and_rows(int64_t B, int64_t H, bool bf16,
                                LstmFwdPlan* plan) {
  for (const int64_t U : kLstmUnits) {
    if (H % U) continue;
    const int64_t tile = kThreads / U;
    const int64_t tiles = ceil_div(B, tile);
    for (int64_t groups = tiles; groups >= 1; --groups)
      if (lstm_fwd_fits(B, H, U, ceil_div(tiles, groups) * tile, bf16, plan))
        return true;
  }
  return false;
}

// kernels/lstm.py lstm_fwd_plan: false where the forward does not take
// (B, H); the bf16 form with no all-rows fallback
inline bool lstm_fwd_plan(int64_t B, int64_t H, LstmFwdPlan* plan,
                          bool bf16 = false) {
  if (bf16)
    return B >= 1 && H >= 8 && H % 8 == 0 &&
           lstm_units_and_rows(B, H, true, plan);
  LstmFwdPlan all_rows;
  if (!lstm_all_rows_plan(B, H, &all_rows)) return false;
  if (lstm_units_and_rows(B, H, false, plan)) return true;
  *plan = all_rows;
  return true;
}

// kernels/lstm.py fwd_plan: the plan of U units and R rows, forced (the
// all-rows kernel has no bf16 form)
inline bool lstm_forced_plan(int64_t B, int64_t H, int64_t U, int64_t R,
                             LstmFwdPlan* plan, bool bf16 = false) {
  if (R == 0 && U == kLstmAllRowsUnits)
    return !bf16 && lstm_all_rows_plan(B, H, plan);
  return lstm_fwd_fits(B, H, U, R, bf16, plan);
}

// --- the GRU forward (csrc/gru_fwd.cu) --------------------------------------

constexpr int64_t kGruUnits = 4;  // the grid kernel's units a block
constexpr int64_t kGruNcol = 3 * kGruUnits;
constexpr int64_t kGruRows = kThreads / (2 * kGruUnits);
constexpr int64_t kClMaxBlocks = 16;
constexpr int64_t kClNs = 3;
constexpr int64_t kClRows[5] = {1, 2, 4, 8, 16};
constexpr int64_t kClBlocks = 8;
constexpr int64_t kClUnits[3] = {16, 8, 4};
constexpr int64_t kClMaxClusters = 8;

// the op's ints for a plan (kernels/gru.py _AUTO, _GRID, _CLUSTER)
constexpr int64_t kGruAuto = 0, kGruGrid = 1, kGruCluster = 2;

// the grid kernel (path kGruGrid, C = R = 0) or the cluster kernel (C
// blocks a cluster, R rows a cluster), `smem` bytes a block
struct GruFwdPlan {
  int64_t path = kGruGrid, C = 0, R = 0, smem = 0;
};

inline int64_t gru_grid_smem(int64_t H) {
  return 4 * ((kGruNcol + kGruRows) * (H + 4) + kGruRows * 2 * kGruUnits);
}

// kernels/gru.py _flag_ring: a bf16 block's mask or reset ring in floats
inline int64_t gru_flag_ring(int64_t R) { return ceil_div(kClNs * R, 4) * 4; }

// kernels/gru.py _cluster_smem_bytes, float32 or the bf16 form's
inline int64_t gru_cluster_smem(int64_t H, int64_t C, int64_t R,
                                bool bf16 = false) {
  const int64_t U = H / C;
  if (bf16)
    return 4 * (3 * U * H + 2 * H * R + kThreads * R + 2 * R * U + 3 * U +
                2 * gru_flag_ring(R)) +
           2 * kClNs * 3 * U * R;
  return 4 * (3 * U * H + 2 * H * R + kThreads * R + R * U + 3 * U +
              kClNs * (3 * U * R + 2 * R));
}

inline GruFwdPlan gru_grid_plan(int64_t H) {
  return {kGruGrid, 0, 0, gru_grid_smem(H)};
}

inline bool gru_cluster_rows(int64_t R) {
  for (const int64_t r : kClRows)
    if (r == R) return true;
  return false;
}

// kernels/gru.py _cluster_fits (bf16: the bf16 form's, H a multiple of 8)
inline bool gru_cluster_fits(int64_t H, int64_t C, int64_t R,
                             bool bf16 = false) {
  return H >= 1 && 1 <= C && C <= kClMaxBlocks && H % C == 0 &&
         (H / C) % 4 == 0 && kThreads % (2 * (H / C)) == 0 &&
         gru_cluster_rows(R) && (!bf16 || H % 8 == 0) &&
         gru_cluster_smem(H, C, R, bf16) <= kSmemPerBlock;
}

// kernels/gru.py cluster_plan: false where no such instance fits
inline bool gru_cluster_plan(int64_t H, int64_t C, int64_t R,
                             GruFwdPlan* plan, bool bf16 = false) {
  if (!gru_cluster_fits(H, C, R, bf16)) return false;
  *plan = {kGruCluster, C, R, gru_cluster_smem(H, C, R, bf16)};
  return true;
}

// kernels/gru.py gru_fwd_plan: the cluster kernel where it fits, else the
// grid kernel; bf16 the same rule where both forms fit
inline GruFwdPlan gru_fwd_plan(int64_t B, int64_t H, bool bf16 = false) {
  int64_t cands[4] = {kClBlocks, 0, 0, 0};
  int n = 1;
  for (const int64_t U : kClUnits)
    if (H % U == 0) cands[n++] = H / U;
  for (int i = 0; i < n; ++i) {
    const int64_t C = cands[i];
    int64_t R = kClRows[4];
    for (const int64_t r : kClRows)
      if (ceil_div(B, r) <= kClMaxClusters) {
        R = r;
        break;
      }
    GruFwdPlan plan;
    if (ceil_div(B, R) * C <= kSms && gru_cluster_fits(H, C, R) &&
        gru_cluster_plan(H, C, R, &plan, bf16))
      return plan;
  }
  return gru_grid_plan(H);
}

}  // namespace ptpu
