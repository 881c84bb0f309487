// Native video decoder: FFmpeg/libav-based frame sampler.
//
// Replacement for the reference's decord dependency (reference:
// llava/vid_utils.py:35-102, languagebind/video/processing_video.py:94-110):
// probe + sparse frame sampling with RGB24 output, multi-threaded codec
// decode, seek-ahead for sparse indices. A copy of
// videollamb_tpu/native/src/video_decoder.cc with one repair: sws_scale
// writes each row through a destination whose stride is padded to
// kRowAlign bytes, then the w * 3 bytes of the row are copied into the
// packed output. swscale's vector paths store whole blocks per row, so a
// packed stride that is no multiple of the block (56 pixels: 168 bytes)
// let the last row write past the end of the caller's buffer.
//
// C ABI consumed via ctypes from videollamb_torch/native/video_decoder.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  AVStream* stream = nullptr;
  std::string error;

  ~Reader() {
    if (sws) sws_freeContext(sws);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  bool open(const char* path, int n_threads) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) {
      error = "open failed";
      return false;
    }
    if (avformat_find_stream_info(fmt, nullptr) < 0) {
      error = "no stream info";
      return false;
    }
    const AVCodec* dec = nullptr;
    stream_index = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (stream_index < 0 || !dec) {
      error = "no video stream";
      return false;
    }
    stream = fmt->streams[stream_index];
    codec = avcodec_alloc_context3(dec);
    if (!codec || avcodec_parameters_to_context(codec, stream->codecpar) < 0) {
      error = "codec params";
      return false;
    }
    codec->thread_count = n_threads;
    codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (avcodec_open2(codec, dec, nullptr) < 0) {
      error = "codec open";
      return false;
    }
    return true;
  }

  double avg_fps() const {
    AVRational r = stream->avg_frame_rate;
    if (r.num <= 0 || r.den <= 0) r = stream->r_frame_rate;
    if (r.num <= 0 || r.den <= 0) return 30.0;
    return av_q2d(r);
  }

  int64_t total_frames() const {
    if (stream->nb_frames > 0) return stream->nb_frames;
    // Estimate from duration.
    int64_t dur = stream->duration;
    if (dur > 0) {
      double secs = dur * av_q2d(stream->time_base);
      return static_cast<int64_t>(secs * avg_fps() + 0.5);
    }
    if (fmt->duration > 0) {
      double secs = static_cast<double>(fmt->duration) / AV_TIME_BASE;
      return static_cast<int64_t>(secs * avg_fps() + 0.5);
    }
    return 0;
  }
};

thread_local std::string g_error;

}  // namespace

extern "C" {

const char* vd_last_error() { return g_error.c_str(); }

// Probe: returns 0 on success; fills total frames, fps, height, width.
int vd_probe(const char* path, int64_t* total, double* fps, int* height,
             int* width) {
  Reader r;
  if (!r.open(path, 1)) {
    g_error = r.error;
    return -1;
  }
  *total = r.total_frames();
  *fps = r.avg_fps();
  *height = r.codec->height;
  *width = r.codec->width;
  return 0;
}

// Decode the frames at the given sorted indices into out (n, H, W, 3) RGB24.
// Sequential decode with keyframe seek-ahead when the gap to the next wanted
// index is large. Returns 0 on success.
int vd_read_frames(const char* path, const int64_t* indices, int n,
                   uint8_t* out, int n_threads) {
  Reader r;
  if (!r.open(path, n_threads)) {
    g_error = r.error;
    return -1;
  }
  const int h = r.codec->height;
  const int w = r.codec->width;
  const size_t row_bytes = static_cast<size_t>(w) * 3;
  const size_t frame_bytes = static_cast<size_t>(h) * row_bytes;
  // One padded RGB24 frame for sws_scale (rows kRowAlign-aligned, and a
  // spare row's slack past the end).
  constexpr size_t kRowAlign = 64;
  const int padded_stride =
      static_cast<int>((row_bytes + kRowAlign - 1) / kRowAlign * kRowAlign);
  std::vector<uint8_t> scratch(static_cast<size_t>(padded_stride) * (h + 1) + kRowAlign);
  uint8_t* padded = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(scratch.data()) + kRowAlign - 1) / kRowAlign * kRowAlign);

  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  if (!frame || !pkt) {
    g_error = "alloc";
    return -1;
  }

  const double fps = r.avg_fps();
  const double tb = av_q2d(r.stream->time_base);
  const int64_t start_time =
      r.stream->start_time == AV_NOPTS_VALUE ? 0 : r.stream->start_time;

  auto pts_to_index = [&](int64_t pts) -> int64_t {
    double secs = (pts - start_time) * tb;
    return static_cast<int64_t>(secs * fps + 0.5);
  };
  auto index_to_ts = [&](int64_t idx) -> int64_t {
    return start_time + static_cast<int64_t>(idx / fps / tb);
  };

  int want = 0;          // next output slot
  int64_t cur_index = -1;  // index of the last decoded frame
  bool draining = false;
  bool just_sought = false;  // suppress re-seek until a frame decodes
  int ret = 0;

  // Seek-ahead threshold: if the next wanted frame is far, keyframe-seek.
  const int64_t kSeekGap = static_cast<int64_t>(fps * 4) + 1;

  while (want < n) {
    const int64_t target = indices[want];
    if (!draining && !just_sought &&
        (cur_index < 0 || target - cur_index > kSeekGap)) {
      if (av_seek_frame(r.fmt, r.stream_index, index_to_ts(target),
                        AVSEEK_FLAG_BACKWARD) >= 0) {
        avcodec_flush_buffers(r.codec);
        cur_index = -1;
        just_sought = true;
      }
    }

    // Pull one decoded frame.
    int got = avcodec_receive_frame(r.codec, frame);
    if (got == AVERROR(EAGAIN)) {
      if (draining) {
        g_error = "EOF before all frames found";
        ret = -1;
        break;
      }
      int rd = av_read_frame(r.fmt, pkt);
      if (rd < 0) {
        draining = true;
        avcodec_send_packet(r.codec, nullptr);
        continue;
      }
      if (pkt->stream_index == r.stream_index) {
        avcodec_send_packet(r.codec, pkt);
      }
      av_packet_unref(pkt);
      continue;
    }
    if (got == AVERROR_EOF) {
      // Fill remaining slots with the last decoded frame if any, else fail.
      if (want > 0) {
        for (; want < n; ++want) {
          std::memcpy(out + static_cast<size_t>(want) * frame_bytes,
                      out + static_cast<size_t>(want - 1) * frame_bytes,
                      frame_bytes);
        }
        break;
      }
      g_error = "EOF with no frames";
      ret = -1;
      break;
    }
    if (got < 0) {
      g_error = "decode error";
      ret = -1;
      break;
    }

    just_sought = false;
    int64_t pts = frame->best_effort_timestamp;
    cur_index = pts == AV_NOPTS_VALUE ? cur_index + 1 : pts_to_index(pts);

    while (want < n && cur_index >= indices[want]) {
      if (!r.sws) {
        r.sws = sws_getContext(w, h, static_cast<AVPixelFormat>(frame->format),
                               w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                               nullptr, nullptr);
        if (!r.sws) {
          g_error = "sws";
          ret = -1;
          break;
        }
      }
      uint8_t* dst[1] = {padded};
      int dst_stride[1] = {padded_stride};
      sws_scale(r.sws, frame->data, frame->linesize, 0, h, dst, dst_stride);
      uint8_t* slot = out + static_cast<size_t>(want) * frame_bytes;
      for (int y = 0; y < h; ++y) {
        std::memcpy(slot + y * row_bytes, padded + static_cast<size_t>(y) * padded_stride,
                    row_bytes);
      }
      ++want;
    }
    av_frame_unref(frame);
    if (ret < 0) break;
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  return ret;
}

}  // extern "C"
