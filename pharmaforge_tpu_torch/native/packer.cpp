// Host-side batch packing: slice + one-hot + pad into dense device buffers.
//
// The TPU-native counterpart of the reference's DGL collate path
// (dataset/protein_pharm_dataset.py:140-179,268-271): instead of building
// ragged heterographs per sample and batching them, the loader packs flat
// preprocessed arrays straight into the padded dense layout the device
// consumes. This is the framework's hot host loop during training (the
// device step is ~ms; Python-level one-hot/pad per batch would become the
// bottleneck at scale), so it lives in C++ with a plain-C ABI loaded via
// ctypes. A pure-numpy fallback with identical semantics lives in
// pharmaforge_tpu/data/batch.py.
//
// Layout contracts (match data/batch.py):
//   positions: float32 [N, 3] flat source; one-hot classes from int32 codes;
//   outputs are caller-allocated [B, slots, ...] buffers, fully overwritten
//   (padding slots zeroed, masks written as uint8 0/1).

#include <cstdint>
#include <cstring>

extern "C" {

// Pack contiguous [start, end) spans of a flat array into padded rows.
//   pos_flat : [n_total, 3] float32
//   feat_flat: [n_total] int32 class codes
//   spans    : [b, 2] int64 (start, end) per batch row
// Outputs (caller-allocated):
//   out_x    : [b, slots, 3] float32
//   out_h    : [b, slots, n_classes] float32 one-hot
//   out_mask : [b, slots] uint8
// Returns 0 on success, -1 if any span exceeds `slots`.
int pack_batch(const float* pos_flat, const int32_t* feat_flat,
               const int64_t* spans, int64_t b, int64_t slots,
               int64_t n_classes, float* out_x, float* out_h,
               uint8_t* out_mask) {
  std::memset(out_x, 0, sizeof(float) * b * slots * 3);
  std::memset(out_h, 0, sizeof(float) * b * slots * n_classes);
  std::memset(out_mask, 0, sizeof(uint8_t) * b * slots);

  for (int64_t i = 0; i < b; ++i) {
    const int64_t start = spans[2 * i];
    const int64_t end = spans[2 * i + 1];
    const int64_t n = end - start;
    if (n > slots || n < 0) return -1;
    float* xrow = out_x + i * slots * 3;
    float* hrow = out_h + i * slots * n_classes;
    uint8_t* mrow = out_mask + i * slots;
    std::memcpy(xrow, pos_flat + start * 3, sizeof(float) * n * 3);
    for (int64_t j = 0; j < n; ++j) {
      const int32_t c = feat_flat[start + j];
      if (c >= 0 && c < n_classes) hrow[j * n_classes + c] = 1.0f;
      mrow[j] = 1;
    }
  }
  return 0;
}

// Gather-based variant for subsample augmentation: row i packs the source
// elements listed in idx_flat[offsets[i] : offsets[i+1]].
int pack_batch_gather(const float* pos_flat, const int32_t* feat_flat,
                      const int64_t* idx_flat, const int64_t* offsets,
                      int64_t b, int64_t slots, int64_t n_classes,
                      float* out_x, float* out_h, uint8_t* out_mask) {
  std::memset(out_x, 0, sizeof(float) * b * slots * 3);
  std::memset(out_h, 0, sizeof(float) * b * slots * n_classes);
  std::memset(out_mask, 0, sizeof(uint8_t) * b * slots);

  for (int64_t i = 0; i < b; ++i) {
    const int64_t start = offsets[i];
    const int64_t n = offsets[i + 1] - start;
    if (n > slots || n < 0) return -1;
    float* xrow = out_x + i * slots * 3;
    float* hrow = out_h + i * slots * n_classes;
    uint8_t* mrow = out_mask + i * slots;
    for (int64_t j = 0; j < n; ++j) {
      const int64_t src = idx_flat[start + j];
      xrow[j * 3 + 0] = pos_flat[src * 3 + 0];
      xrow[j * 3 + 1] = pos_flat[src * 3 + 1];
      xrow[j * 3 + 2] = pos_flat[src * 3 + 2];
      const int32_t c = feat_flat[src];
      if (c >= 0 && c < n_classes) hrow[j * n_classes + c] = 1.0f;
      mrow[j] = 1;
    }
  }
  return 0;
}

}  // extern "C"
