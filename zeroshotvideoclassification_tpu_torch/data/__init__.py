"""Data layer: host-side index math + decode (numpy only, the port's own
copy of the JAX package's host side), and host batch -> device batch.

All variability lives host-side in integer index space — frame selection
(TSN), crop offsets, flip flags, source sizes — while the device sees only
static shapes: a uint8 canvas [B, T, Hc, Wc, 3] plus small per-sample
parameter vectors. One fused device kernel (K1) then performs
bilinear-resize + crop + flip + normalize exactly matching the reference's
CPU transform chain (reference/auxiliary/transforms.py:41-56).
"""

from zeroshotvideoclassification_tpu_torch.data.sampling import (
    tsn_selection,
    tsn_frame_indices,
)
from zeroshotvideoclassification_tpu_torch.data.transform_params import (
    TransformParams,
    resized_dims,
    make_transform_params,
)
