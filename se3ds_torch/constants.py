"""Constants for the SE3DS PyTorch port (a copy of `se3ds_tpu.constants`)."""

# Default checkpoint locations of the released models (Orbax format,
# which only the JAX package restores; see `SE3DSModel`).
CKPT_UNSEEN = 'data/se3ds_ckpt'
CKPT_RE10K = 'data/se3ds_re10k_ckpt'

INVALID_SEM_VALUE = 0  # Corresponds to MP3D void class.
INVALID_RGB_VALUE = -1  # Negative value to avoid collision with black pixels.

PI = 3.1415926535897932384626433
HFOV = 90 * PI / 180
DEPTH_SCALE = 20.0

NUM_MP3D_CLASSES = 42
PANO_VIDEO_LENGTH = 8  # Maximum sequence length of R2R data used in evaluation.
