"""Host adapters: the native host runtime (frame ring, depth codecs, PLY
writer), the native mission control plane, and the topic bus."""

from otslam_tpu_torch.adapters.native import (  # noqa: F401
    load_native,
    native_available,
    FrameRing,
)
