// Host C++ ops of the evaluation and data path (counterpart of
// odise_tpu/native/host_ops.cpp, the same four functions with the same
// results): panoptic PNG ids, PQ's pixel-pair intersections, mask IoU and
// per-id areas. Not a device kernel: it runs on the host, over contiguous
// numpy buffers, behind a plain C interface that
// odise_torch/utils/host_ops.py loads with ctypes. odise_torch/ops/_build.py
// compiles it with the host's C++ compiler at first use.

#include <cstdint>
#include <cstring>
#include <unordered_map>

extern "C" {

// rgb [n * 3] uint8 -> ids [n] uint32 (panopticapi's rgb2id)
void rgb2id(const uint8_t* rgb, uint32_t* ids, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = rgb + i * 3;
    ids[i] = (uint32_t)p[0] + 256u * (uint32_t)p[1] + 65536u * (uint32_t)p[2];
  }
}

// The distinct (gt, pred) id pairs of two uint32 maps of n pixels, each as
// gt << 32 | pred, with its pixel count. Writes at most max_pairs of them
// and returns how many there are: a caller whose buffer was too small
// calls again with a larger one.
int64_t pq_intersections(const uint32_t* gt, const uint32_t* pred, int64_t n,
                         uint64_t* out_pairs, uint64_t* out_counts, int64_t max_pairs) {
  std::unordered_map<uint64_t, uint64_t> acc;
  acc.reserve(1024);
  for (int64_t i = 0; i < n; ++i) {
    ++acc[((uint64_t)gt[i] << 32) | (uint64_t)pred[i]];
  }
  int64_t m = 0;
  for (const auto& kv : acc) {
    if (m < max_pairs) {
      out_pairs[m] = kv.first;
      out_counts[m] = kv.second;
    }
    ++m;
  }
  return m;
}

// IoU of two masks of n uint8 pixels (nonzero = in); 0 where both are empty.
double mask_iou(const uint8_t* a, const uint8_t* b, int64_t n) {
  int64_t inter = 0, uni = 0;
  for (int64_t i = 0; i < n; ++i) {
    const bool av = a[i] != 0, bv = b[i] != 0;
    inter += (av && bv);
    uni += (av || bv);
  }
  return uni ? (double)inter / (double)uni : 0.0;
}

// Pixels per id over a uint32 id map; ids >= num_ids are not counted.
void bincount_u32(const uint32_t* ids, int64_t n, uint64_t* counts, int64_t num_ids) {
  std::memset(counts, 0, sizeof(uint64_t) * num_ids);
  for (int64_t i = 0; i < n; ++i) {
    if (ids[i] < (uint64_t)num_ids) ++counts[ids[i]];
  }
}

}  // extern "C"
