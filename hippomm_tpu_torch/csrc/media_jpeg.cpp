// The port's host media shim: baseline JPEG encode/decode (libjpeg) and an
// MJPEG-AVI RIFF container reader/writer with frame-exact random access.
//
// A copy of the libjpeg half of hippomm_tpu/media/_native/media_shim.cpp
// (the libav half waits for its own slice). Plain C ABI, loaded through
// ctypes by hippomm_tpu_torch/ops/_native.media_lib(), which builds it on
// first use with `g++ -O3 -fPIC -shared -std=c++17 ... -ljpeg -pthread`.
//
// Batch decode runs on a thread pool sized to the host's cores.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG codec
// ---------------------------------------------------------------------------

struct HmmJpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void hmm_jpeg_error_exit(j_common_ptr cinfo) {
  HmmJpegErr* err = reinterpret_cast<HmmJpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG from memory. If rgb_out is null, only fills *w/*h.
// rgb_out must hold w*h*3 bytes. Returns 0 on success.
int hmm_jpeg_decode(const uint8_t* buf, size_t len, uint8_t* rgb_out, int* w,
                    int* h) {
  jpeg_decompress_struct cinfo;
  HmmJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = hmm_jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  if (!rgb_out) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  int stride = cinfo.output_width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb_out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode RGB to JPEG in memory. *out_len: in = capacity, out = bytes written.
int hmm_jpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                    uint8_t* out, size_t* out_len) {
  jpeg_compress_struct cinfo;
  HmmJpegErr jerr;
  // The longjmp error path must free jpeg_mem_dest's buffer —
  // jpeg_destroy_compress does NOT (ownership is the caller's), so bailing
  // without free() leaked w*h*3 bytes per failed encode. jpeg_mem_dest
  // retains &mem, so mem itself stays a plain local; the volatile VIEW of
  // its stack slot makes the post-longjmp read well-defined.
  unsigned char* mem = nullptr;
  unsigned char* volatile* mem_ref = &mem;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = hmm_jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    free(*mem_ref);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  int stride = w * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    const uint8_t* row = rgb + (size_t)cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, const_cast<uint8_t**>(&row), 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  if (mem_len > *out_len) {
    free(mem);
    return -2;  // caller buffer too small
  }
  memcpy(out, mem, mem_len);
  *out_len = mem_len;
  free(mem);
  return 0;
}

// Batch decode: n JPEGs (concatenated buffer + offsets/sizes) into a packed
// (n, h, w, 3) output. All images must share one resolution (w, h). Uses a
// thread pool sized to hardware concurrency.
int hmm_jpeg_decode_batch(const uint8_t* buf, const int64_t* offsets,
                          const int64_t* sizes, int n, uint8_t* rgb_out,
                          int w, int h) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  size_t frame_bytes = (size_t)w * h * 3;
  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  nthreads = std::min(nthreads, n);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int dw = 0, dh = 0;
      // header-only pass FIRST: the slot holds exactly w*h*3 bytes, and a
      // corrupt/crafted stream whose embedded JPEG is larger would be
      // written BEFORE any dimension check — heap corruption
      if (hmm_jpeg_decode(buf + offsets[i], (size_t)sizes[i], nullptr,
                          &dw, &dh) != 0 ||
          dw != w || dh != h ||
          hmm_jpeg_decode(buf + offsets[i], (size_t)sizes[i],
                          rgb_out + frame_bytes * i, &dw, &dh) != 0) {
        failed.fetch_add(1);
      }
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failed.load() ? -1 : 0;
}

// ---------------------------------------------------------------------------
// MJPEG-AVI container
// ---------------------------------------------------------------------------

static void put_le32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 24) & 0xff);
}

static void put_fourcc(std::vector<uint8_t>& v, const char* cc) {
  v.insert(v.end(), cc, cc + 4);
}

struct AviReader {
  FILE* f = nullptr;
  int width = 0, height = 0;
  double fps = 0.0;
  std::vector<int64_t> frame_offsets;  // offset of JPEG payload
  std::vector<int64_t> frame_sizes;
};

static uint32_t rd_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

void* hmm_avi_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  AviReader* r = new AviReader();
  r->f = f;

  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "AVI ", 4) != 0) {
    fclose(f);
    delete r;
    return nullptr;
  }
  // Walk chunks; gather avih (fps), strf (dims), and 00dc frames in movi.
  uint32_t us_per_frame = 0;
  bool last_strh_vids = false;
  std::vector<int64_t> list_ends;
  for (;;) {
    uint8_t ch[8];
    if (fread(ch, 1, 8, f) != 8) break;
    uint32_t size = rd_le32(ch + 4);
    if (memcmp(ch, "LIST", 4) == 0) {
      uint8_t kind[4];
      if (fread(kind, 1, 4, f) != 4) break;
      // descend into the list
      continue;
    }
    long payload = ftell(f);
    if (memcmp(ch, "avih", 4) == 0 && size >= 4) {
      uint8_t b[4];
      fread(b, 1, 4, f);
      us_per_frame = rd_le32(b);
      fseek(f, payload + ((size + 1) & ~1u), SEEK_SET);
    } else if (memcmp(ch, "strh", 4) == 0 && size >= 4) {
      uint8_t b[4];
      fread(b, 1, 4, f);
      last_strh_vids = memcmp(b, "vids", 4) == 0;
      fseek(f, payload + ((size + 1) & ~1u), SEEK_SET);
    } else if (memcmp(ch, "strf", 4) == 0 && size >= 16 && last_strh_vids) {
      // only the VIDEO stream's BITMAPINFOHEADER: an audio strf
      // (WAVEFORMATEX) here would overwrite width/height with
      // nSamplesPerSec/nAvgBytesPerSec
      uint8_t b[16];
      fread(b, 1, 16, f);
      r->width = (int)rd_le32(b + 4);
      r->height = (int)rd_le32(b + 8);
      fseek(f, payload + ((size + 1) & ~1u), SEEK_SET);
    } else if (ch[2] == 'd' && (ch[3] == 'c' || ch[3] == 'b')) {
      // video frame chunk (e.g. 00dc)
      r->frame_offsets.push_back(payload);
      r->frame_sizes.push_back(size);
      fseek(f, payload + ((size + 1) & ~1u), SEEK_SET);
    } else {
      fseek(f, payload + ((size + 1) & ~1u), SEEK_SET);
    }
  }
  r->fps = us_per_frame ? 1e6 / us_per_frame : 30.0;
  bool looks_mjpeg = false;
  if (!r->frame_offsets.empty()) {
    uint8_t soi[2] = {0, 0};
    fseek(f, r->frame_offsets[0], SEEK_SET);
    looks_mjpeg =
        fread(soi, 1, 2, f) == 2 && soi[0] == 0xFF && soi[1] == 0xD8;
  }
  if (r->width <= 0 || r->frame_offsets.empty() || !looks_mjpeg) {
    // not an MJPEG-AVI this shim can decode: fail at open (io.py open_video
    // names the libav slice for other AVI codecs) instead of failing later
    // at libjpeg decode time
    fclose(f);
    delete r;
    return nullptr;
  }
  return r;
}

int hmm_avi_info(void* h, int* w, int* hgt, double* fps, int64_t* nframes) {
  AviReader* r = static_cast<AviReader*>(h);
  *w = r->width;
  *hgt = r->height;
  *fps = r->fps;
  *nframes = (int64_t)r->frame_offsets.size();
  return 0;
}

// Read raw JPEG payload of frame idx; *len in = capacity, out = size.
int hmm_avi_read_raw(void* h, int64_t idx, uint8_t* out, int64_t* len) {
  AviReader* r = static_cast<AviReader*>(h);
  if (idx < 0 || idx >= (int64_t)r->frame_offsets.size()) return -1;
  int64_t sz = r->frame_sizes[idx];
  if (sz > *len) return -2;
  fseek(r->f, r->frame_offsets[idx], SEEK_SET);
  if (fread(out, 1, (size_t)sz, r->f) != (size_t)sz) return -3;
  *len = sz;
  return 0;
}

int64_t hmm_avi_frame_size(void* h, int64_t idx) {
  AviReader* r = static_cast<AviReader*>(h);
  if (idx < 0 || idx >= (int64_t)r->frame_sizes.size()) return -1;
  return r->frame_sizes[idx];
}

// Decode frames [start, start+count) into packed (count, h, w, 3) RGB.
int hmm_avi_read_frames(void* h, int64_t start, int64_t count,
                        uint8_t* rgb_out) {
  AviReader* r = static_cast<AviReader*>(h);
  if (start < 0 || start + count > (int64_t)r->frame_offsets.size()) return -1;
  // Read raw payloads sequentially (single fd), decode in parallel.
  std::vector<uint8_t> blob;
  std::vector<int64_t> offs(count), sizes(count);
  int64_t total = 0;
  for (int64_t i = 0; i < count; ++i) total += r->frame_sizes[start + i];
  blob.resize((size_t)total);
  int64_t pos = 0;
  for (int64_t i = 0; i < count; ++i) {
    int64_t sz = r->frame_sizes[start + i];
    fseek(r->f, r->frame_offsets[start + i], SEEK_SET);
    if (fread(blob.data() + pos, 1, (size_t)sz, r->f) != (size_t)sz) return -3;
    offs[i] = pos;
    sizes[i] = sz;
    pos += sz;
  }
  return hmm_jpeg_decode_batch(blob.data(), offs.data(), sizes.data(),
                               (int)count, rgb_out, r->width, r->height);
}

// Decode an arbitrary index set (e.g. fps-subsampled) into packed RGB.
int hmm_avi_read_indices(void* h, const int64_t* indices, int64_t count,
                         uint8_t* rgb_out) {
  AviReader* r = static_cast<AviReader*>(h);
  std::vector<uint8_t> blob;
  std::vector<int64_t> offs(count), sizes(count);
  int64_t total = 0;
  for (int64_t i = 0; i < count; ++i) {
    int64_t idx = indices[i];
    if (idx < 0 || idx >= (int64_t)r->frame_offsets.size()) return -1;
    total += r->frame_sizes[idx];
  }
  blob.resize((size_t)total);
  int64_t pos = 0;
  for (int64_t i = 0; i < count; ++i) {
    int64_t idx = indices[i];
    int64_t sz = r->frame_sizes[idx];
    fseek(r->f, r->frame_offsets[idx], SEEK_SET);
    if (fread(blob.data() + pos, 1, (size_t)sz, r->f) != (size_t)sz) return -3;
    offs[i] = pos;
    sizes[i] = sz;
    pos += sz;
  }
  return hmm_jpeg_decode_batch(blob.data(), offs.data(), sizes.data(),
                               (int)count, rgb_out, r->width, r->height);
}

void hmm_avi_close(void* h) {
  AviReader* r = static_cast<AviReader*>(h);
  if (r->f) fclose(r->f);
  delete r;
}

// ---------------------------- writer --------------------------------------

struct AviWriter {
  FILE* f = nullptr;
  int width = 0, height = 0, quality = 90;
  double fps = 30.0;
  std::vector<uint32_t> frame_sizes;
  long movi_start = 0;
};

void* hmm_avi_writer_open(const char* path, int w, int h, double fps,
                          int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  AviWriter* wr = new AviWriter();
  wr->f = f;
  wr->width = w;
  wr->height = h;
  wr->fps = fps;
  wr->quality = quality;
  // Header is rewritten with real sizes on close; reserve its fixed 224-byte layout.
  std::vector<uint8_t> pad(224, 0);
  fwrite(pad.data(), 1, pad.size(), f);
  wr->movi_start = ftell(f);
  return wr;
}

int hmm_avi_writer_write(void* h, const uint8_t* rgb) {
  AviWriter* wr = static_cast<AviWriter*>(h);
  size_t cap = (size_t)wr->width * wr->height * 3 + 65536;
  std::vector<uint8_t> jpg(cap);
  size_t len = cap;
  if (hmm_jpeg_encode(rgb, wr->width, wr->height, wr->quality, jpg.data(),
                      &len) != 0)
    return -1;
  std::vector<uint8_t> chunk;
  put_fourcc(chunk, "00dc");
  put_le32(chunk, (uint32_t)len);
  fwrite(chunk.data(), 1, chunk.size(), wr->f);
  fwrite(jpg.data(), 1, len, wr->f);
  if (len & 1) fputc(0, wr->f);  // RIFF chunks are 2-byte aligned
  wr->frame_sizes.push_back((uint32_t)len);
  return 0;
}

int hmm_avi_writer_close(void* h) {
  AviWriter* wr = static_cast<AviWriter*>(h);
  long end = ftell(wr->f);
  uint32_t nframes = (uint32_t)wr->frame_sizes.size();
  uint32_t movi_size = (uint32_t)(end - wr->movi_start) + 4;

  // Build the 232-byte header: RIFF('AVI ' LIST(hdrl avih LIST(strl strh
  // strf)) LIST(movi ...)).
  std::vector<uint8_t> hd;
  put_fourcc(hd, "RIFF");
  put_le32(hd, (uint32_t)(end - 8));
  put_fourcc(hd, "AVI ");

  put_fourcc(hd, "LIST");
  put_le32(hd, 4 + 8 + 56 + 8 + 4 + 8 + 56 + 8 + 40);  // hdrl payload
  put_fourcc(hd, "hdrl");

  put_fourcc(hd, "avih");
  put_le32(hd, 56);
  put_le32(hd, (uint32_t)(1e6 / wr->fps));          // us per frame
  put_le32(hd, 0);                                   // max bytes/sec
  put_le32(hd, 0);                                   // padding
  put_le32(hd, 0);  // flags: no idx1 chunk is written, so AVIF_HASINDEX (0x10)
                    // must be CLEAR — advertising an index that does not
                    // exist breaks strict demuxers' seeking
  put_le32(hd, nframes);
  put_le32(hd, 0);                                   // initial frames
  put_le32(hd, 1);                                   // streams
  put_le32(hd, 0);                                   // suggested buffer
  put_le32(hd, (uint32_t)wr->width);
  put_le32(hd, (uint32_t)wr->height);
  for (int i = 0; i < 4; ++i) put_le32(hd, 0);       // reserved

  put_fourcc(hd, "LIST");
  put_le32(hd, 4 + 8 + 56 + 8 + 40);  // strl payload
  put_fourcc(hd, "strl");

  put_fourcc(hd, "strh");
  put_le32(hd, 56);
  put_fourcc(hd, "vids");
  put_fourcc(hd, "MJPG");
  put_le32(hd, 0);                     // flags
  put_le32(hd, 0);                     // priority+language
  put_le32(hd, 0);                     // initial frames
  put_le32(hd, 1000);                  // scale
  put_le32(hd, (uint32_t)(wr->fps * 1000 + 0.5));  // rate
  put_le32(hd, 0);                     // start
  put_le32(hd, nframes);               // length
  put_le32(hd, 0);                     // suggested buffer
  put_le32(hd, 0xffffffff);            // quality
  put_le32(hd, 0);                     // sample size
  put_le32(hd, 0);                     // rcFrame (l,t)
  {
    // rcFrame right/bottom as two le16 pairs
    uint32_t rb = ((uint32_t)wr->height << 16) | (uint32_t)wr->width;
    put_le32(hd, rb);
  }

  put_fourcc(hd, "strf");
  put_le32(hd, 40);  // BITMAPINFOHEADER
  put_le32(hd, 40);
  put_le32(hd, (uint32_t)wr->width);
  put_le32(hd, (uint32_t)wr->height);
  put_le32(hd, (1 /*planes*/) | (24u /*bpp*/ << 16));
  put_fourcc(hd, "MJPG");
  put_le32(hd, (uint32_t)(wr->width * wr->height * 3));
  put_le32(hd, 0);
  put_le32(hd, 0);
  put_le32(hd, 0);
  put_le32(hd, 0);

  put_fourcc(hd, "LIST");
  put_le32(hd, movi_size);
  put_fourcc(hd, "movi");

  if (hd.size() != 224) {  // keep in sync with the reserved pad
    fclose(wr->f);
    delete wr;
    return -(int)hd.size();
  }
  fseek(wr->f, 0, SEEK_SET);
  fwrite(hd.data(), 1, hd.size(), wr->f);
  fclose(wr->f);
  delete wr;
  return 0;
}

}  // extern "C"
