"""Model-wide constants.

Parity notes: mirrors the reference constant table (reference:
llava/constants.py:7-33) — same token strings and sentinel indices so that
checkpoints, datasets and prompts are interchangeable. A copy of
``videollamb_tpu/constants.py``.
"""

IGNORE_INDEX = -100

# Image
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# Video
VIDEO_TOKEN_INDEX = -201
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VIDEO_PATCH_TOKEN = "<vi_patch>"
DEFAULT_VI_START_TOKEN = "<vi_start>"
DEFAULT_VI_END_TOKEN = "<vi_end>"
VIDEO_PLACEHOLDER = "<video-placeholder>"

# X (unified modality table). AUDIO is an extension beyond the reference
# (whose table stops at IMAGE/VIDEO even though it vendors the LanguageBind
# audio encoder): the splice treats ANY negative sentinel uniformly, so
# -202 rides the same fusion path. The -200/-201 entries stay byte-
# identical to reference llava/constants.py:26-33 for checkpoint/dataset
# interchange.
X_TOKEN_INDEX = {"IMAGE": -200, "VIDEO": -201, "AUDIO": -202}
X_INDEX_TOKEN = {-200: "IMAGE", -201: "VIDEO", -202: "AUDIO"}
DEFAULT_X_TOKEN = {"IMAGE": "<image>", "VIDEO": "<video>", "AUDIO": "<audio>"}
DEFAULT_X_PATCH_TOKEN = {"IMAGE": "<im_patch>", "VIDEO": "<vi_patch>",
                         "AUDIO": "<au_patch>"}
DEFAULT_X_START_TOKEN = {"IMAGE": "<im_start>", "VIDEO": "<vi_start>",
                         "AUDIO": "<au_start>"}
DEFAULT_X_END_TOKEN = {"IMAGE": "<im_end>", "VIDEO": "<vi_end>",
                       "AUDIO": "<au_end>"}
X_PLACEHOLDER = {"IMAGE": "<image-placeholder>", "VIDEO": "<video-placeholder>",
                 "AUDIO": "<audio-placeholder>"}
