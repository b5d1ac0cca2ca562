// merge_path_relax: one whole pass of the merge-path executor over the
// frontier's edges, fused, for Hopper (sm_90a).
//
// Replaces, on the main path, the Pallas TPU kernel
// src/repro/kernels/merge_path.py:107 (merge_path_map) together with the
// gather / msg / scatter-combine epilogue that
// src/repro/kernels/ops.py:130 (merge_path_apply) and :96
// (merge_path_apply_static) run around it.  The ids [0, n), n =
// n_tiles * tile, are cut into tiles of `tile` consecutive ids (tile t
// owns [t * tile, (t + 1) * tile)); an id below `total` maps to
//
//   j  = clip(upper_bound(start_e[0:H), id) - 1, 0, H-1)
//   ge = row_start[j] + (id - start_e[j]),   src = hvidx[j]
//
// (the searchsorted-right rule: a run of zero-degree slots resolves to
// its last slot) and combines, for every query b, as tile_relax.cuh
// says: push at col_idx[ge] from values[b, src], pull at src from
// values[b, col_idx[ge]].  Ids at or past `total` are masked before any
// load; no distribution and no tile count apply.  `labels` is combined
// into in place and must not alias `values`.
//
// What bounds it on this card: bytes.  A live id reads its 4-byte
// col_idx (and 4-byte weight for v + w) and touches one value or label
// per live query; a slot costs its 12 bytes once.  The unfused route
// wrote 9 bytes an id (edge, slot, mask) to HBM for n ids, read them
// back, built [B, n] candidate and index tensors and wrote fresh [B, V]
// labels; in the static round n was every edge of the graph (E ids a
// round, whatever the frontier).
//
// Design: the tile walk, its shared-memory window stage and the id loop
// are tile_relax.cuh's, which edge_lb_relax.cu's cyclic deal shares at
// a fixed tile of 2048 ids; here the tile is the configured one (any
// positive multiple of 128) and the stage is sized `tile + 1` entries,
// dynamic shared memory, up to what a block can hold.  Over a slot list
// whose every slot owns an edge (the static round's LB-all list, the
// host round's bucketed members) a tile spans at most tile + 1 slots,
// so its window is staged; a layout with zero-degree runs, such as one
// over V rows, or a tile past what shared memory holds searches its
// window in global memory.  `total` comes from the host (the host
// round's bucketed span `ecap`) or, when `total_ptr` is non-null, from
// one int32 on the device, and `h` is bounded by one int32 on the
// device when `rows_ptr` is non-null: the static round hands the kernel
// the round's LB-all list (csrc/twc_list.cu) with its member count and
// edge total.  With a device total the grid is resident (the blocks the
// card holds at once walk the tiles below the total), so a static
// round costs what its frontier's edges cost, not E ids, and a total
// of 0 costs one launch whose blocks exit at once.  The kernel
// allocates nothing, reads no device value on the host and launches on
// the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_count.cuh"
#include "tile_relax.cuh"

// dtype: 0 int32, 1 float32; add: 0 min, 1 add (float32 takes add only).
// span = n_tiles * tile ids; total_ptr: null, or one int32 on the device
// that replaces `total`; rows_ptr: null, or one int32 on the device
// that bounds the slots to [0, min(h, *rows_ptr)).
extern "C" int merge_path_relax_launch(
    const void* values, void* labels, const void* fmask, const void* col_idx,
    const void* edge_w, const void* hvidx, const void* start_e,
    const void* row_start, const void* total_ptr, const void* rows_ptr,
    int h, int total, int span, int tile, int nb, int v, int dtype, int add,
    int pull, int kind, void* stream) {
  if (tile <= 0 || tile % 128) return (int)cudaErrorInvalidValue;
  if (nb == 0 || span <= 0 || h <= 0) return 0;
  if (total_ptr == nullptr && total <= 0) return 0;
  const tiles::Pass p{static_cast<const int32_t*>(col_idx),
                      static_cast<const int32_t*>(edge_w),
                      static_cast<const int32_t*>(hvidx), nb, v, kind};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MP_RELAX_CALL(T, ADD, PULL)                                          \
  tiles::launch_tiles<T, ADD, PULL>(p, values, labels, fmask, start_e,       \
                                    row_start, total_ptr, rows_ptr, h,       \
                                    total, span, tile, s)
  if (dtype == 0 && !add) return pull ? MP_RELAX_CALL(int32_t, false, true)
                                      : MP_RELAX_CALL(int32_t, false, false);
  if (dtype == 0) return pull ? MP_RELAX_CALL(int32_t, true, true)
                              : MP_RELAX_CALL(int32_t, true, false);
  if (dtype == 1 && add) return pull ? MP_RELAX_CALL(float, true, true)
                                     : MP_RELAX_CALL(float, true, false);
#undef MP_RELAX_CALL
  return (int)cudaErrorInvalidValue;
}
