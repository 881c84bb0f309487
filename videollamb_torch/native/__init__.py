"""The libav video decoder (``video_decoder.py`` over ``src/video_decoder.cc``)."""
