"""The symbols of the program's hand-written kernels (``csrc/*.cu``), by the
job each does; the readers match them as whole words in the trace's
operation names."""

RASTER = ("pack_fwd_kernel", "pack_bwd_partial_kernel", "pack_bwd_reduce_kernel",
          "raster_fwd_kernel", "raster_bwd_kernel")
LOSS = ("loss_fwd_kernel", "loss_reduce_kernel", "loss_bwd_kernel")
OTHER = ("raster_v3_boxes_kernel", "raster_v3_fwd_kernel", "raster_v3_bwd_kernel",
         "row_boxes_kernel", "raster_ids_kernel", "gather_rows_bwd_kernel",
         "segment_sum_kernel")
ALL = RASTER + LOSS + OTHER
