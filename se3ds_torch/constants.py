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

# Matterport3D semantic class ids.
MP3D_ID2CLASS = {
    0: 'void',
    1: 'wall',
    2: 'floor',
    3: 'chair',
    4: 'door',
    5: 'table',
    6: 'picture',
    7: 'cabinet',
    8: 'cushion',
    9: 'window',
    10: 'sofa',
    11: 'bed',
    12: 'curtain',
    13: 'chest_of_drawers',
    14: 'plant',
    15: 'sink',
    16: 'stairs',
    17: 'ceiling',
    18: 'toilet',
    19: 'stool',
    20: 'towel',
    21: 'mirror',
    22: 'tv_monitor',
    23: 'shower',
    24: 'column',
    25: 'bathtub',
    26: 'counter',
    27: 'fireplace',
    28: 'lighting',
    29: 'beam',
    30: 'railing',
    31: 'shelving',
    32: 'blinds',
    33: 'gym_equipment',
    34: 'seating',
    35: 'board_panel',
    36: 'furniture',
    37: 'appliances',
    38: 'clothes',
    39: 'objects',
    40: 'misc',
    41: 'masking',  # Used to handle blurred RGB regions.
}
