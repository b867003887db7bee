// The port's libav media shim: a copy of the JAX package's
// hippomm_tpu/media/_native/media_libav.cpp, built on its own (not linked with
// the libjpeg shim) by ops/_native.media_libav_lib(), so a host with libav and
// no libjpeg, or the reverse, still gets what it has.
//
// Real-world container support (.mp4/.mov/.mkv/.webm/.avi): demux + decode via
// libavformat/libavcodec, color conversion via libswscale, audio demux +
// resample to the framework's canonical 16 kHz mono float32 via libswresample.
// Replaces the reference's OpenCV VideoCapture loops, decord batch decode, and
// every ffmpeg *subprocess* (reference: hippomm/core/batch_process.py:151-330,
// hippomm/core/hippocampal_memory.py:1386-1396, 3064-3078,
// hippomm/models/foundation_models.py:251-260) with in-process C++ — no forks,
// no pipes, pinned host buffers handed straight to numpy/ctypes.
//
// Design notes:
//  * Index-based frame access assumes near-constant frame rate (the reference
//    makes the same assumption via CAP_PROP_POS_MSEC arithmetic). Indices are
//    resolved through presentation timestamps, so B-frame reordering and
//    container start offsets are handled.
//  * Sorted-index batch reads walk the stream forward and only seek when the
//    gap is large (> ~4 s), so fps-subsampled ingest reads are one sequential
//    decode pass.
//  * The gray output path scales directly to the scoring resolution in C++
//    (SWS_AREA), so Python ships (B, gh, gw) uint8 to the device — the
//    smallest possible host->device payload for SSIM keyframe scoring.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Encoders/decoders are chatty at INFO; keep stderr for real errors only.
struct AvLogInit {
  AvLogInit() { av_log_set_level(AV_LOG_ERROR); }
} g_av_log_init;

struct AvReader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* vdec = nullptr;
  int vstream = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  double duration = 0.0;
  int64_t nframes = 0;
  bool has_audio = false;
  AVRational tb{1, 1};
  int64_t start_pts = 0;
  AVFrame* frame = nullptr;  // last successfully decoded frame (held copy)
  AVFrame* dec = nullptr;    // scratch frame for avcodec_receive_frame
  AVPacket* pkt = nullptr;
  bool draining = false;
  bool eof = false;
  bool have_frame = false;  // r->frame holds valid decoded data
  int64_t last_idx = -1;  // presentation index of the frame currently held
  SwsContext* sws_rgb = nullptr;
  SwsContext* sws_gray = nullptr;
  int gray_w = 0, gray_h = 0;
};

int64_t frame_index(const AvReader* r, int64_t pts) {
  if (pts == AV_NOPTS_VALUE) return r->last_idx + 1;
  double t = (double)(pts - r->start_pts) * av_q2d(r->tb);
  return (int64_t)llround(t * r->fps);
}

// Decode the next frame in presentation order into the scratch frame, then
// move it into r->frame (the HELD frame). avcodec_receive_frame unrefs its
// output frame when returning EOF, so decoding into r->frame directly would
// clobber the held frame the at-EOF clamp path depends on (feeding an empty
// AVFrame to sws_scale aborts the process).
// Returns 0 ok, 1 EOF, <0 error.
int decode_next(AvReader* r) {
  for (;;) {
    int rc = avcodec_receive_frame(r->vdec, r->dec);
    if (rc == 0) {
      av_frame_unref(r->frame);
      av_frame_move_ref(r->frame, r->dec);
      r->have_frame = true;
      int64_t pts = r->frame->best_effort_timestamp;
      r->last_idx = frame_index(r, pts);
      return 0;
    }
    if (rc == AVERROR_EOF) {
      r->eof = true;
      return 1;
    }
    if (rc != AVERROR(EAGAIN)) return rc;
    if (r->draining) {
      // decoder wants input but we already sent EOF
      r->eof = true;
      return 1;
    }
    // feed one video packet
    for (;;) {
      rc = av_read_frame(r->fmt, r->pkt);
      if (rc == AVERROR_EOF) {
        avcodec_send_packet(r->vdec, nullptr);
        r->draining = true;
        break;
      }
      if (rc < 0) return rc;
      if (r->pkt->stream_index == r->vstream) {
        rc = avcodec_send_packet(r->vdec, r->pkt);
        av_packet_unref(r->pkt);
        if (rc < 0 && rc != AVERROR(EAGAIN)) return rc;
        break;
      }
      av_packet_unref(r->pkt);
    }
  }
}

int seek_to_index(AvReader* r, int64_t idx) {
  double t = (double)idx / r->fps;
  int64_t ts = r->start_pts + (int64_t)llround(t / av_q2d(r->tb));
  int rc = av_seek_frame(r->fmt, r->vstream, ts, AVSEEK_FLAG_BACKWARD);
  if (rc < 0) return rc;
  avcodec_flush_buffers(r->vdec);
  r->draining = false;
  r->eof = false;
  r->last_idx = idx - 1;  // provisional; real pts overrides on next decode
  return 0;
}

// Advance the stream so r->frame holds the frame for index `idx` (or the
// nearest one at/after it; at EOF the last decoded frame is reused — the
// container's frame-count metadata can overestimate, e.g. mkv whose audio
// track outlasts the video). `r->have_frame` tracks held-frame validity, so
// earlier indices remain reachable via backward seek even after EOF.
int position_at(AvReader* r, int64_t idx) {
  // Seek when the forward gap exceeds ~4 s of FRAMES (fps-relative, small
  // floor: a 64-frame floor at 2 fps meant 32 s gaps decoded linearly).
  const int64_t SEEK_GAP = std::max<int64_t>((int64_t)(4.0 * r->fps), 8);
  // `cursor_valid`: last_idx reflects the stream position (a seek leaves the
  // held frame intact but the position provisional)
  bool cursor_valid = r->have_frame;
  if (cursor_valid && r->last_idx >= idx) {
    // At/just past the wanted index (fps-rounding jitter): reuse the held
    // frame. Far past it (an earlier index than a previous call): seek back.
    if (r->last_idx <= idx + 2) return 0;
    if (seek_to_index(r, idx) == 0) {
      cursor_valid = false;
    } else {
      return 0;  // unseekable container: best effort, reuse held frame
    }
  }
  if (!r->eof && (idx - (cursor_valid ? r->last_idx : 0)) > SEEK_GAP) {
    if (seek_to_index(r, idx) < 0) {
      // fall through to linear decode on seek failure (some containers)
    } else {
      cursor_valid = false;
    }
  }
  for (;;) {
    int rc = decode_next(r);
    if (rc == 1) {  // EOF: clamp to the held frame if any
      return r->have_frame ? 0 : -1;
    }
    if (rc < 0) return rc;
    if (r->last_idx >= idx) return 0;
  }
}

void copy_rgb_frame(AvReader* r, const AVFrame* f, uint8_t* dst) {
  if (!r->sws_rgb) {
    r->sws_rgb = sws_getContext(
        f->width, f->height, (AVPixelFormat)f->format, r->width, r->height,
        AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  }
  uint8_t* planes[4] = {dst, nullptr, nullptr, nullptr};
  int strides[4] = {3 * r->width, 0, 0, 0};
  sws_scale(r->sws_rgb, f->data, f->linesize, 0, f->height, planes, strides);
}

void copy_rgb(AvReader* r, uint8_t* dst) { copy_rgb_frame(r, r->frame, dst); }

void copy_gray(AvReader* r, uint8_t* dst, int gw, int gh) {
  if (r->sws_gray && (r->gray_w != gw || r->gray_h != gh)) {
    sws_freeContext(r->sws_gray);
    r->sws_gray = nullptr;
  }
  if (!r->sws_gray) {
    r->sws_gray = sws_getContext(
        r->frame->width, r->frame->height, (AVPixelFormat)r->frame->format, gw,
        gh, AV_PIX_FMT_GRAY8, SWS_AREA, nullptr, nullptr, nullptr);
    r->gray_w = gw;
    r->gray_h = gh;
  }
  uint8_t* planes[4] = {dst, nullptr, nullptr, nullptr};
  int strides[4] = {gw, 0, 0, 0};
  sws_scale(r->sws_gray, r->frame->data, r->frame->linesize, 0,
            r->frame->height, planes, strides);
}

}  // namespace

extern "C" {

void hmm_av_close(void* h);

void* hmm_av_open(const char* path) {
  AvReader* r = new AvReader();
  if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
    delete r;
    return nullptr;
  }
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  r->vstream = av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (r->vstream < 0 || !codec) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  AVStream* st = r->fmt->streams[r->vstream];
  r->vdec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(r->vdec, st->codecpar);
  r->vdec->thread_count = 0;  // auto
  r->vdec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  // NOTE: skip_loop_filter=AVDISCARD_ALL was measured (2026-08-19, 600 s
  // fps=2 640x360 synth vlog, 1 core): 4.14-4.30 s vs 4.20-4.56 s baseline —
  // no win; this content is intra-bound (GOP 4), so the knob stays out.
  if (avcodec_open2(r->vdec, codec, nullptr) < 0) {
    avcodec_free_context(&r->vdec);
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  r->width = r->vdec->width;
  r->height = r->vdec->height;
  r->tb = st->time_base;
  r->start_pts = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  r->fps = fr.num ? av_q2d(fr) : 30.0;
  if (st->duration != AV_NOPTS_VALUE && st->duration > 0) {
    r->duration = (double)st->duration * av_q2d(r->tb);
  } else if (r->fmt->duration != AV_NOPTS_VALUE && r->fmt->duration > 0) {
    r->duration = (double)r->fmt->duration / AV_TIME_BASE;
  }
  r->nframes = st->nb_frames > 0
                   ? st->nb_frames
                   : (int64_t)llround(r->duration * r->fps);
  r->has_audio =
      av_find_best_stream(r->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0) >= 0;
  r->frame = av_frame_alloc();
  r->dec = av_frame_alloc();
  r->pkt = av_packet_alloc();
  if (r->width <= 0 || r->height <= 0 || r->nframes <= 0) {
    // still usable if dims known; nframes==0 streams are rejected
    if (r->width <= 0 || r->height <= 0) {
      hmm_av_close(r);
      return nullptr;
    }
  }
  return r;
}

int hmm_av_info(void* h, int* w, int* hgt, double* fps, double* duration,
                int64_t* nframes, int* has_audio) {
  AvReader* r = static_cast<AvReader*>(h);
  *w = r->width;
  *hgt = r->height;
  *fps = r->fps;
  *duration = r->duration;
  *nframes = r->nframes;
  *has_audio = r->has_audio ? 1 : 0;
  return 0;
}

// Decode frames at sorted ascending indices into packed (count, H, W, 3) RGB.
int hmm_av_read_rgb_indices(void* h, const int64_t* idx, int64_t count,
                            uint8_t* rgb) {
  AvReader* r = static_cast<AvReader*>(h);
  size_t frame_bytes = (size_t)r->width * r->height * 3;
  for (int64_t i = 0; i < count; ++i) {
    if (i > 0 && idx[i] < idx[i - 1]) return -2;  // must be sorted
    int rc = position_at(r, idx[i]);
    if (rc < 0) return rc;
    copy_rgb(r, rgb + frame_bytes * i);
  }
  return 0;
}

// Decode frames at sorted ascending indices, scaled to (gh, gw) GRAY8.
int hmm_av_read_gray_indices(void* h, const int64_t* idx, int64_t count,
                             int gw, int gh, uint8_t* gray) {
  AvReader* r = static_cast<AvReader*>(h);
  size_t frame_bytes = (size_t)gw * gh;
  for (int64_t i = 0; i < count; ++i) {
    if (i > 0 && idx[i] < idx[i - 1]) return -2;
    int rc = position_at(r, idx[i]);
    if (rc < 0) return rc;
    copy_gray(r, gray + frame_bytes * i, gw, gh);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Block-hold decode: decode a block of sorted indices ONCE, emit scoring luma
// immediately, and RETAIN refcounted AVFrames so full RGB is converted LAZILY
// — only for the few frames the keyframe walk decides to keep. The eager
// gray+rgb path above converts every candidate (most of which are dropped);
// at ~10 ms per full-res sws conversion that dominates the ingest wall.
// ---------------------------------------------------------------------------

struct AvBlock {
  AvReader* reader = nullptr;
  std::vector<AVFrame*> frames;  // one ref per decoded candidate
};

// skip_nonref != 0 sets AVDISCARD_NONREF for the duration of the call: frames
// no other frame references (most B-frames) are never decoded. Used when the
// candidate stride is large (high-fps sources sampled at ~1 Hz) — a wanted
// index that lands on a skipped frame clamps to the nearest decoded reference
// frame (within the B-run, tens of ms), immaterial for keyframe scoring.
int hmm_av_read_block_hold(void* h, const int64_t* idx, int64_t count, int gw,
                           int gh, int skip_nonref, uint8_t* gray,
                           void** block_out) {
  AvReader* r = static_cast<AvReader*>(h);
  AvBlock* blk = new AvBlock();
  blk->reader = r;
  blk->frames.reserve(count);
  size_t gray_bytes = (size_t)gw * gh;
  if (skip_nonref) r->vdec->skip_frame = AVDISCARD_NONREF;
  for (int64_t i = 0; i < count; ++i) {
    if ((i > 0 && idx[i] < idx[i - 1]) || position_at(r, idx[i]) < 0) {
      for (AVFrame* f : blk->frames) av_frame_free(&f);
      delete blk;
      r->vdec->skip_frame = AVDISCARD_DEFAULT;
      return i > 0 && idx[i] < idx[i - 1] ? -2 : -1;
    }
    copy_gray(r, gray + gray_bytes * i, gw, gh);
    AVFrame* f = av_frame_alloc();
    av_frame_ref(f, r->frame);  // buffer ref, no pixel copy
    blk->frames.push_back(f);
  }
  r->vdec->skip_frame = AVDISCARD_DEFAULT;
  *block_out = blk;
  return 0;
}

// Convert held frames at block-local positions `js` (ascending not required)
// to packed full-res RGB24.
int hmm_av_block_take_rgb(void* bh, const int64_t* js, int64_t n,
                          uint8_t* rgb) {
  AvBlock* blk = static_cast<AvBlock*>(bh);
  size_t rgb_bytes = (size_t)blk->reader->width * blk->reader->height * 3;
  for (int64_t i = 0; i < n; ++i) {
    if (js[i] < 0 || js[i] >= (int64_t)blk->frames.size()) return -2;
    copy_rgb_frame(blk->reader, blk->frames[js[i]], rgb + rgb_bytes * i);
  }
  return 0;
}

void hmm_av_block_free(void* bh) {
  AvBlock* blk = static_cast<AvBlock*>(bh);
  if (!blk) return;
  for (AVFrame* f : blk->frames) av_frame_free(&f);
  delete blk;
}

void hmm_av_close(void* h) {
  AvReader* r = static_cast<AvReader*>(h);
  if (!r) return;
  if (r->sws_rgb) sws_freeContext(r->sws_rgb);
  if (r->sws_gray) sws_freeContext(r->sws_gray);
  if (r->frame) av_frame_free(&r->frame);
  if (r->pkt) av_packet_free(&r->pkt);
  if (r->dec) av_frame_free(&r->dec);
  if (r->vdec) avcodec_free_context(&r->vdec);
  if (r->fmt) avformat_close_input(&r->fmt);
  delete r;
}

// ---------------------------------------------------------------------------
// Audio demux: container -> 16 kHz mono float32, time-windowed.
// Replaces the reference's `ffmpeg -ss .. -to .. -ar 16000 -ac 1` subprocesses
// (batch_process.py:266-290, hippocampal_memory.py:3064-3078).
// ---------------------------------------------------------------------------

struct AvAudio {
  std::vector<float> samples;
};

void* hmm_av_audio_decode(const char* path, double t0, double t1,
                          int64_t* n_out) {
  *n_out = -1;
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return nullptr;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  int astream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (astream < 0 || !codec) {
    avformat_close_input(&fmt);
    return nullptr;
  }
  AVStream* st = fmt->streams[astream];
  AVCodecContext* dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec, st->codecpar);
  if (avcodec_open2(dec, codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return nullptr;
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, 16000,
                          &dec->ch_layout, dec->sample_fmt, dec->sample_rate,
                          0, nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return nullptr;
  }

  int64_t start_pts = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  if (t0 > 0) {
    int64_t ts = start_pts + (int64_t)llround(t0 / av_q2d(st->time_base));
    if (av_seek_frame(fmt, astream, ts, AVSEEK_FLAG_BACKWARD) >= 0)
      avcodec_flush_buffers(dec);
  }

  AvAudio* out = new AvAudio();
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  std::vector<float> chunk;
  bool draining = false;
  double clip_t0 = std::max(0.0, t0);
  bool done = false;
  while (!done) {
    int rc = avcodec_receive_frame(dec, frame);
    if (rc == AVERROR_EOF) break;
    if (rc == AVERROR(EAGAIN)) {
      if (draining) break;
      rc = av_read_frame(fmt, pkt);
      if (rc == AVERROR_EOF) {
        avcodec_send_packet(dec, nullptr);
        draining = true;
        continue;
      }
      if (rc < 0) break;
      if (pkt->stream_index == astream) avcodec_send_packet(dec, pkt);
      av_packet_unref(pkt);
      continue;
    }
    if (rc < 0) break;
    double t = frame->best_effort_timestamp == AV_NOPTS_VALUE
                   ? clip_t0
                   : (double)(frame->best_effort_timestamp - start_pts) *
                         av_q2d(st->time_base);
    double frame_dur = (double)frame->nb_samples / dec->sample_rate;
    if (t1 >= 0 && t >= t1) {
      done = true;
    }
    if (done) break;
    // resample whole frame, then trim to the [t0, t1) window
    int max_out = (int)av_rescale_rnd(
        swr_get_delay(swr, dec->sample_rate) + frame->nb_samples, 16000,
        dec->sample_rate, AV_ROUND_UP);
    chunk.resize((size_t)max_out);
    uint8_t* outp = reinterpret_cast<uint8_t*>(chunk.data());
    int got = swr_convert(swr, &outp, max_out,
                          const_cast<const uint8_t**>(frame->extended_data),
                          frame->nb_samples);
    if (got > 0) {
      int64_t lo = 0, hi = got;
      if (t < clip_t0) lo = std::min<int64_t>(got, llround((clip_t0 - t) * 16000));
      if (t1 >= 0 && t + frame_dur > t1)
        hi = std::max<int64_t>(lo, got - llround((t + frame_dur - t1) * 16000));
      out->samples.insert(out->samples.end(), chunk.begin() + lo,
                          chunk.begin() + hi);
    }
  }
  // drain the resampler
  {
    int max_out = (int)av_rescale_rnd(swr_get_delay(swr, dec->sample_rate),
                                      16000, dec->sample_rate, AV_ROUND_UP);
    if (max_out > 0 && !done) {
      chunk.resize((size_t)max_out);
      uint8_t* outp = reinterpret_cast<uint8_t*>(chunk.data());
      int got = swr_convert(swr, &outp, max_out, nullptr, 0);
      if (got > 0)
        out->samples.insert(out->samples.end(), chunk.begin(),
                            chunk.begin() + got);
    }
  }
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  *n_out = (int64_t)out->samples.size();
  return out;
}

int hmm_av_audio_take(void* h, float* dst) {
  AvAudio* a = static_cast<AvAudio*>(h);
  memcpy(dst, a->samples.data(), a->samples.size() * sizeof(float));
  delete a;
  return 0;
}

void hmm_av_audio_free(void* h) { delete static_cast<AvAudio*>(h); }

// ---------------------------------------------------------------------------
// Writer: RGB frames + mono float PCM -> mp4/mov/mkv/avi (H.264 or MPEG-4
// video, AAC audio). Used for fixtures, tests, and re-encoding tooling.
// ---------------------------------------------------------------------------

struct AvWriter {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* venc = nullptr;
  AVCodecContext* aenc = nullptr;
  AVStream* vst = nullptr;
  AVStream* ast = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* vframe = nullptr;
  AVFrame* aframe = nullptr;
  AVPacket* pkt = nullptr;
  int width = 0, height = 0;
  double fps = 30.0;
  int sample_rate = 0;
  int64_t vcount = 0;
  std::vector<float> pcm;     // pending mono samples @ sample_rate
  int64_t pcm_consumed = 0;   // samples already encoded
  int64_t apts = 0;
  bool header_written = false;
  int error = 0;
};

static int wr_send_packets(AvWriter* w, AVCodecContext* enc, AVStream* st) {
  for (;;) {
    int rc = avcodec_receive_packet(enc, w->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    av_packet_rescale_ts(w->pkt, enc->time_base, st->time_base);
    w->pkt->stream_index = st->index;
    rc = av_interleaved_write_frame(w->fmt, w->pkt);
    if (rc < 0) return rc;
  }
}

// Encode pending audio frames whose start time < t_limit (seconds).
static int wr_pump_audio(AvWriter* w, double t_limit) {
  if (!w->aenc) return 0;
  int fsz = w->aenc->frame_size > 0 ? w->aenc->frame_size : 1024;
  for (;;) {
    double t = (double)w->apts / w->sample_rate;
    if (t_limit >= 0 && t >= t_limit) return 0;
    if ((int64_t)w->pcm.size() - w->pcm_consumed < fsz) return 0;
    av_frame_make_writable(w->aframe);
    float* dst = reinterpret_cast<float*>(w->aframe->data[0]);
    memcpy(dst, w->pcm.data() + w->pcm_consumed, fsz * sizeof(float));
    w->aframe->pts = w->apts;
    w->apts += fsz;
    w->pcm_consumed += fsz;
    int rc = avcodec_send_frame(w->aenc, w->aframe);
    if (rc < 0) return rc;
    rc = wr_send_packets(w, w->aenc, w->ast);
    if (rc < 0) return rc;
  }
}

void* hmm_av_writer_open(const char* path, int width, int height, double fps,
                         int sample_rate, const char* vcodec_name) {
  AvWriter* w = new AvWriter();
  w->width = width;
  w->height = height;
  w->fps = fps;
  w->sample_rate = sample_rate;
  if (avformat_alloc_output_context2(&w->fmt, nullptr, nullptr, path) < 0 ||
      !w->fmt) {
    delete w;
    return nullptr;
  }
  const AVCodec* vc = nullptr;
  if (vcodec_name && vcodec_name[0])
    vc = avcodec_find_encoder_by_name(vcodec_name);
  if (!vc) vc = avcodec_find_encoder_by_name("libx264");
  if (!vc) vc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!vc) {
    avformat_free_context(w->fmt);
    delete w;
    return nullptr;
  }
  w->vst = avformat_new_stream(w->fmt, nullptr);
  w->venc = avcodec_alloc_context3(vc);
  w->venc->width = width;
  w->venc->height = height;
  AVRational fr = av_d2q(fps, 100000);
  w->venc->time_base = av_inv_q(fr);
  w->venc->framerate = fr;
  w->venc->pix_fmt = AV_PIX_FMT_YUV420P;
  w->venc->gop_size = (int)std::max(1.0, fps * 2);
  if (vc->id == AV_CODEC_ID_H264) {
    av_opt_set(w->venc->priv_data, "preset", "veryfast", 0);
    av_opt_set(w->venc->priv_data, "crf", "20", 0);
  } else {
    w->venc->bit_rate = (int64_t)width * height * (int64_t)std::max(1.0, fps) / 4;
  }
  if (w->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    w->venc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(w->venc, vc, nullptr) < 0) goto fail;
  avcodec_parameters_from_context(w->vst->codecpar, w->venc);
  w->vst->time_base = w->venc->time_base;

  if (sample_rate > 0) {
    const AVCodec* ac = avcodec_find_encoder(AV_CODEC_ID_AAC);
    if (!ac) goto fail;
    w->ast = avformat_new_stream(w->fmt, nullptr);
    w->aenc = avcodec_alloc_context3(ac);
    w->aenc->sample_rate = sample_rate;
    w->aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    {
      AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
      av_channel_layout_copy(&w->aenc->ch_layout, &mono);
    }
    w->aenc->time_base = AVRational{1, sample_rate};
    w->aenc->bit_rate = 96000;
    if (w->fmt->oformat->flags & AVFMT_GLOBALHEADER)
      w->aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(w->aenc, ac, nullptr) < 0) goto fail;
    avcodec_parameters_from_context(w->ast->codecpar, w->aenc);
    w->ast->time_base = w->aenc->time_base;
    w->aframe = av_frame_alloc();
    w->aframe->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_copy(&w->aframe->ch_layout, &w->aenc->ch_layout);
    w->aframe->sample_rate = sample_rate;
    w->aframe->nb_samples = w->aenc->frame_size > 0 ? w->aenc->frame_size : 1024;
    if (av_frame_get_buffer(w->aframe, 0) < 0) goto fail;
  }

  if (!(w->fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&w->fmt->pb, path, AVIO_FLAG_WRITE) < 0) goto fail;
  }
  if (avformat_write_header(w->fmt, nullptr) < 0) goto fail;
  w->header_written = true;

  w->vframe = av_frame_alloc();
  w->vframe->format = AV_PIX_FMT_YUV420P;
  w->vframe->width = width;
  w->vframe->height = height;
  if (av_frame_get_buffer(w->vframe, 0) < 0) goto fail;
  w->sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                          AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr,
                          nullptr);
  w->pkt = av_packet_alloc();
  return w;

fail:
  if (w->venc) avcodec_free_context(&w->venc);
  if (w->aenc) avcodec_free_context(&w->aenc);
  if (w->vframe) av_frame_free(&w->vframe);
  if (w->aframe) av_frame_free(&w->aframe);
  if (w->fmt) {
    if (w->fmt->pb) avio_closep(&w->fmt->pb);
    avformat_free_context(w->fmt);
  }
  delete w;
  return nullptr;
}

int hmm_av_writer_video(void* h, const uint8_t* rgb) {
  AvWriter* w = static_cast<AvWriter*>(h);
  av_frame_make_writable(w->vframe);
  const uint8_t* src[4] = {rgb, nullptr, nullptr, nullptr};
  int stride[4] = {3 * w->width, 0, 0, 0};
  sws_scale(w->sws, src, stride, 0, w->height, w->vframe->data,
            w->vframe->linesize);
  w->vframe->pts = w->vcount++;
  int rc = avcodec_send_frame(w->venc, w->vframe);
  if (rc < 0) return rc;
  rc = wr_send_packets(w, w->venc, w->vst);
  if (rc < 0) return rc;
  // keep audio interleaved up to the current video time
  return wr_pump_audio(w, (double)w->vcount / w->fps);
}

int hmm_av_writer_audio(void* h, const float* pcm, int64_t n) {
  AvWriter* w = static_cast<AvWriter*>(h);
  if (!w->aenc) return -1;
  w->pcm.insert(w->pcm.end(), pcm, pcm + n);
  return 0;
}

int hmm_av_writer_close(void* h) {
  AvWriter* w = static_cast<AvWriter*>(h);
  int rc = 0;
  if (w->header_written) {
    // flush remaining audio (all of it), then both encoders
    rc = wr_pump_audio(w, -1.0);
    if (rc == 0 && w->aenc) {
      // tail shorter than one encoder frame: zero-pad
      int fsz = w->aenc->frame_size > 0 ? w->aenc->frame_size : 1024;
      int64_t left = (int64_t)w->pcm.size() - w->pcm_consumed;
      if (left > 0) {
        av_frame_make_writable(w->aframe);
        float* dst = reinterpret_cast<float*>(w->aframe->data[0]);
        memset(dst, 0, fsz * sizeof(float));
        memcpy(dst, w->pcm.data() + w->pcm_consumed, left * sizeof(float));
        w->aframe->pts = w->apts;
        w->apts += left;
        avcodec_send_frame(w->aenc, w->aframe);
        wr_send_packets(w, w->aenc, w->ast);
      }
      avcodec_send_frame(w->aenc, nullptr);
      wr_send_packets(w, w->aenc, w->ast);
    }
    if (w->venc) {
      avcodec_send_frame(w->venc, nullptr);
      wr_send_packets(w, w->venc, w->vst);
    }
    int rc2 = av_write_trailer(w->fmt);
    if (rc == 0) rc = rc2;
  }
  if (w->sws) sws_freeContext(w->sws);
  if (w->pkt) av_packet_free(&w->pkt);
  if (w->vframe) av_frame_free(&w->vframe);
  if (w->aframe) av_frame_free(&w->aframe);
  if (w->venc) avcodec_free_context(&w->venc);
  if (w->aenc) avcodec_free_context(&w->aenc);
  if (w->fmt) {
    if (w->fmt->pb) avio_closep(&w->fmt->pb);
    avformat_free_context(w->fmt);
  }
  delete w;
  return rc;
}

}  // extern "C"
