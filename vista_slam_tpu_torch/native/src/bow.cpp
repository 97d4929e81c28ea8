// Native bag-of-binary-words kernels (host side).
//
// Accelerates the hot loops of native/bow.py — vocabulary-tree descent over
// ORB descriptors and L1 scoring of sparse BoW vectors — which the reference
// delegates to the DBoW3 C++ submodule (reference: vista_slam/
// loop_detector.py:6-33). Exposed through a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC bow.cpp -o libvistabow.so

#include <cstdint>
#include <cstring>

namespace {

inline int hamming256(const uint8_t* a, const uint8_t* b) {
  uint64_t wa[4], wb[4];
  std::memcpy(wa, a, 32);
  std::memcpy(wb, b, 32);
  int d = 0;
  for (int i = 0; i < 4; ++i) d += __builtin_popcountll(wa[i] ^ wb[i]);
  return d;
}

}  // namespace

extern "C" {

// Map m 32-byte descriptors to leaf word ids by greedy tree descent.
// child_idx:  [num_nodes, k] int32, -1 marks absent children
// child_desc: [num_nodes, k, 32] uint8 descriptors of each child
// node_word:  [num_nodes] int32, -1 for internal nodes
void vb_descend(const int32_t* child_idx, const uint8_t* child_desc,
                const int32_t* node_word, int32_t num_nodes, int32_t k,
                int32_t levels, const uint8_t* desc, int32_t m,
                int32_t* out_words) {
  for (int32_t i = 0; i < m; ++i) {
    const uint8_t* d = desc + i * 32;
    int32_t cur = 0;
    for (int32_t lvl = 0; lvl <= levels; ++lvl) {
      const int32_t* kids = child_idx + (int64_t)cur * k;
      if (kids[0] < 0) break;
      int best = -1, best_dist = 1 << 30;
      const uint8_t* cd = child_desc + (int64_t)cur * k * 32;
      for (int32_t c = 0; c < k; ++c) {
        if (kids[c] < 0) continue;
        int dist = hamming256(d, cd + (int64_t)c * 32);
        if (dist < best_dist) {
          best_dist = dist;
          best = kids[c];
        }
      }
      if (best < 0) break;
      cur = best;
    }
    out_words[i] = node_word[cur];
  }
}

// DBoW L1 similarity of two sorted sparse vectors:
//   s = 0.5 * sum_{i in both} (|a_i| + |b_i| - |a_i - b_i|)
float vb_l1_score(const int32_t* ids_a, const float* vals_a, int32_t na,
                  const int32_t* ids_b, const float* vals_b, int32_t nb) {
  float s = 0.0f;
  int32_t i = 0, j = 0;
  while (i < na && j < nb) {
    if (ids_a[i] == ids_b[j]) {
      float va = vals_a[i], vb = vals_b[j];
      float ava = va < 0 ? -va : va;
      float avb = vb < 0 ? -vb : vb;
      float avd = va - vb < 0 ? vb - va : va - vb;
      s += ava + avb - avd;
      ++i;
      ++j;
    } else if (ids_a[i] < ids_b[j]) {
      ++i;
    } else {
      ++j;
    }
  }
  return 0.5f * s;
}

}  // extern "C"
