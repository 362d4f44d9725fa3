// Native depth-image IO and a threaded frame prefetcher. The port's copy of
// levelsetfusion_tpu/native/depth_io.cpp, with its C ABI (lsf_png_info,
// lsf_load_depth_png, lsf_prefetcher_create/next/destroy), loaded with
// ctypes by io/native_loader.py.
//
// The reference decodes with libpng. This copy needs only zlib: it walks the
// PNG's chunks itself, inflates the IDAT stream with zlib's `uncompress`
// into a buffer of the exact size the header gives, and undoes the five row
// filters (None, Sub, Up, Average, Paeth). That covers what a depth image
// is: greyscale, grey + alpha, RGB or RGBA at bit depth 8 or 16, not
// interlaced; the first channel is kept (16-bit samples as stored, 8-bit
// ones widened). Palette, interlaced and 1/2/4-bit images are refused
// (LSF_UNSUPPORTED), and CRCs are checked.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread depth_io.cpp -lz

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status {
  LSF_OK = 0,
  LSF_OPEN = -1,         // the file cannot be opened or read
  LSF_FORMAT = -2,       // not a PNG, a chunk truncated or failing its CRC
  LSF_SIZE = -3,         // the image is not the caller's width x height
  LSF_UNSUPPORTED = -4,  // palette, interlaced, or a bit depth other than 8/16
  LSF_INFLATE = -5,      // the IDAT stream does not inflate to the image's size
  LSF_FILTER = -6,       // a row names an unknown filter type
};

const unsigned char kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int read_file(const char* path, std::vector<unsigned char>* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return LSF_OPEN;
  unsigned char buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof buf, fp)) > 0) out->insert(out->end(), buf, buf + n);
  const bool failed = ferror(fp) != 0;
  fclose(fp);
  return failed ? LSF_OPEN : LSF_OK;
}

struct Png {
  int width = 0, height = 0, bit_depth = 0, colour = 0, interlace = 0;
  std::vector<unsigned char> idat;
};

int channels_of(int colour) {
  switch (colour) {
    case 0: return 1;  // greyscale
    case 2: return 3;  // RGB
    case 4: return 2;  // grey + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

// Walks the chunks of `data` up to IEND, checking each CRC; with
// `header_only`, stops after IHDR.
int parse(const std::vector<unsigned char>& data, Png* png, bool header_only) {
  if (data.size() < 8 || memcmp(data.data(), kSignature, 8) != 0) return LSF_FORMAT;
  size_t pos = 8;
  bool have_header = false;
  while (pos + 12 <= data.size()) {
    const uint32_t length = be32(&data[pos]);
    if (length > data.size() - pos - 12) return LSF_FORMAT;
    const unsigned char* kind = &data[pos + 4];
    const unsigned char* payload = &data[pos + 8];
    const uint32_t crc = be32(&data[pos + 8 + length]);
    if (uint32_t(crc32(0L, kind, length + 4)) != crc) return LSF_FORMAT;
    if (memcmp(kind, "IHDR", 4) == 0) {
      if (length != 13) return LSF_FORMAT;
      png->width = int(be32(payload));
      png->height = int(be32(payload + 4));
      png->bit_depth = payload[8];
      png->colour = payload[9];
      png->interlace = payload[12];
      have_header = true;
      if (header_only) return LSF_OK;
    } else if (memcmp(kind, "IDAT", 4) == 0) {
      png->idat.insert(png->idat.end(), payload, payload + length);
    } else if (memcmp(kind, "IEND", 4) == 0) {
      return have_header ? LSF_OK : LSF_FORMAT;
    }
    pos += 12 + size_t(length);
  }
  return LSF_FORMAT;
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undoes row y's filter in place; `prev` is the unfiltered row above (or
// null for the first row).
int unfilter(unsigned char* row, const unsigned char* prev, size_t stride, size_t bpp) {
  const int kind = row[-1];
  for (size_t i = 0; i < stride; ++i) {
    const int left = i >= bpp ? row[i - bpp] : 0;
    const int up = prev ? prev[i] : 0;
    const int upleft = (prev && i >= bpp) ? prev[i - bpp] : 0;
    int pred;
    switch (kind) {
      case 0: return LSF_OK;
      case 1: pred = left; break;
      case 2: pred = up; break;
      case 3: pred = (left + up) >> 1; break;
      case 4: pred = paeth(left, up, upleft); break;
      default: return LSF_FILTER;
    }
    row[i] = static_cast<unsigned char>(row[i] + pred);
  }
  return LSF_OK;
}

}  // namespace

extern "C" {

// The image's width, height and bit depth from its IHDR. Returns 0 on
// success, else a negative status.
int lsf_png_info(const char* path, int* width, int* height, int* bit_depth) {
  std::vector<unsigned char> data;
  int rc = read_file(path, &data);
  if (rc != LSF_OK) return rc;
  Png png;
  rc = parse(data, &png, true);
  if (rc != LSF_OK) return rc;
  *width = png.width;
  *height = png.height;
  *bit_depth = png.bit_depth;
  return LSF_OK;
}

// Decodes the PNG's first channel into `out` (uint16, row-major, width *
// height elements). Returns 0 on success, else a negative status.
int lsf_load_depth_png(const char* path, uint16_t* out, int width, int height) {
  std::vector<unsigned char> data;
  int rc = read_file(path, &data);
  if (rc != LSF_OK) return rc;
  Png png;
  rc = parse(data, &png, false);
  if (rc != LSF_OK) return rc;
  if (png.width != width || png.height != height) return LSF_SIZE;
  const int channels = channels_of(png.colour);
  if (channels == 0 || png.interlace != 0 || (png.bit_depth != 8 && png.bit_depth != 16))
    return LSF_UNSUPPORTED;
  const size_t sample = png.bit_depth / 8;
  const size_t bpp = channels * sample;
  const size_t stride = size_t(width) * bpp;
  const size_t expected = size_t(height) * (stride + 1);
  std::vector<unsigned char> raw(expected);
  uLongf got = expected;
  if (uncompress(raw.data(), &got, png.idat.data(), png.idat.size()) != Z_OK ||
      got != expected)
    return LSF_INFLATE;
  for (int y = 0; y < height; ++y) {
    unsigned char* row = raw.data() + size_t(y) * (stride + 1) + 1;
    const unsigned char* prev = y ? row - (stride + 1) : nullptr;
    rc = unfilter(row, prev, stride, bpp);
    if (rc != LSF_OK) return rc;
    uint16_t* dst = out + size_t(y) * width;
    for (int x = 0; x < width; ++x) {
      const unsigned char* px = row + size_t(x) * bpp;
      dst[x] = sample == 2 ? uint16_t((px[0] << 8) | px[1]) : px[0];  // big-endian
    }
  }
  return LSF_OK;
}

// ---------------------------------------------------------------------------
// Threaded prefetcher: decodes a fixed list of frames ahead of consumption,
// preserving order, with a bounded number of in-flight decodes.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  size_t next_submit = 0;
  size_t next_consume = 0;
  size_t max_inflight = 4;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;
  struct Slot {
    std::vector<uint16_t> data;
    int status = 1;  // 1 = pending, 0 = ok, <0 = error
    bool done = false;
  };
  std::deque<std::unique_ptr<Slot>> slots;  // slot i = frame next_consume + i
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      size_t idx;
      Slot* slot;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] {
          return stop || (next_submit < paths.size() &&
                          next_submit - next_consume < max_inflight);
        });
        if (stop) return;
        idx = next_submit++;
        while (slots.size() <= idx - next_consume)
          slots.emplace_back(new Slot());
        slot = slots[idx - next_consume].get();
      }
      std::vector<uint16_t> buf(static_cast<size_t>(width) * height);
      int rc = lsf_load_depth_png(paths[idx].c_str(), buf.data(), width, height);
      {
        // `slot` stays valid: the deque holds unique_ptrs (stable targets)
        // and a slot is only popped once marked done, in order.
        std::unique_lock<std::mutex> lock(mu);
        slot->data = std::move(buf);
        slot->status = rc;
        slot->done = true;
        cv.notify_all();
      }
    }
  }
};

void* lsf_prefetcher_create(const char** paths, int n, int width, int height,
                            int num_threads, int max_inflight) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->width = width;
  p->height = height;
  p->max_inflight = max_inflight > 0 ? max_inflight : 4;
  const int nt = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until the next frame (in order) is decoded; copies it into out.
// Returns the decode status (0 ok), or -100 if past the end.
int lsf_prefetcher_next(void* handle, uint16_t* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->next_consume >= p->paths.size()) return -100;
  p->cv.notify_all();
  p->cv.wait(lock, [&] {
    return !p->slots.empty() && p->slots.front()->done;
  });
  auto slot = std::move(p->slots.front());
  p->slots.pop_front();
  p->next_consume++;
  p->cv.notify_all();
  if (slot->status == 0)
    std::memcpy(out, slot->data.data(), slot->data.size() * sizeof(uint16_t));
  return slot->status;
}

void lsf_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::unique_lock<std::mutex> lock(p->mu);
    p->stop = true;
    p->cv.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
