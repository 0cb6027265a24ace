// The source views of the cond-query kernels (cosine_prior.cu: B and B';
// block_cosine_prior.cu: D and D'; fused_cosine.cu: F; supercell_color.cu:
// E, which also takes one view): how many they take, and the pair order.
#pragma once

constexpr int MIN_V = 2;        // n_src_views the prior kernels take
constexpr int MAX_V = 8;        // the last V with compiled instances (B, F) and registers (D)
constexpr int MAX_V_WIDE = 16;  // the last V the run-time-V forms take (MAX_V + 1 onwards)

__host__ __device__ constexpr int n_pairs(int V) { return V * (V - 1) / 2; }

// pair p of pair_index_lists(V) (matchnerf_tpu/models/gmflow/gmflow.py:28):
// (0,1), (0,2), ..., (0,V-1), (1,2), ..., (V-2,V-1). In the pair (i, j)
// view i's chunk j-1 meets view j's chunk i (matchnerf.py:393-402).
__host__ __device__ constexpr int pair_first(int V, int p) {
  int i = 0;
  while (p >= V - 1 - i) {
    p -= V - 1 - i;
    ++i;
  }
  return i;
}

__host__ __device__ constexpr int pair_second(int V, int p) {
  const int i = pair_first(V, p);
  return p - i * (2 * V - i - 1) / 2 + i + 1;
}

static_assert(pair_first(3, 2) == 1 && pair_second(3, 2) == 2, "(1,2) is pair 2 of 3 views");
static_assert(pair_first(4, 2) == 0 && pair_second(4, 2) == 3, "(0,3) is pair 2 of 4 views");
static_assert(pair_first(4, 4) == 1 && pair_second(4, 4) == 3, "(1,3) is pair 4 of 4 views");
static_assert(pair_first(4, 5) == 2 && pair_second(4, 5) == 3, "(2,3) is pair 5 of 4 views");
static_assert(pair_first(2, 0) == 0 && pair_second(2, 0) == 1, "(0,1) is the pair of 2 views");
static_assert(pair_first(8, 6) == 0 && pair_second(8, 6) == 7, "(0,7) is pair 6 of 8 views");
static_assert(pair_first(8, 7) == 1 && pair_second(8, 7) == 2, "(1,2) is pair 7 of 8 views");
static_assert(pair_first(8, 26) == 5 && pair_second(8, 26) == 7, "(5,7) is pair 26 of 8 views");
static_assert(pair_first(8, 27) == 6 && pair_second(8, 27) == 7, "(6,7) is pair 27 of 8 views");
static_assert(pair_first(5, 9) == 3 && pair_second(5, 9) == 4, "(3,4) is pair 9 of 5 views");
static_assert(n_pairs(MAX_V) == 28, "8 views make 28 pairs");
static_assert(pair_first(10, 44) == 8 && pair_second(10, 44) == 9, "(8,9) is pair 44 of 10 views");
static_assert(pair_first(16, 14) == 0 && pair_second(16, 14) == 15, "(0,15) is pair 14 of 16 views");
static_assert(pair_first(16, 15) == 1 && pair_second(16, 15) == 2, "(1,2) is pair 15 of 16 views");
static_assert(pair_first(16, 60) == 4 && pair_second(16, 60) == 11, "(4,11) is pair 60 of 16 views");
static_assert(pair_first(16, 119) == 14 && pair_second(16, 119) == 15,
              "(14,15) is pair 119 of 16 views");
static_assert(n_pairs(MAX_V_WIDE) == 120, "16 views make 120 pairs");
