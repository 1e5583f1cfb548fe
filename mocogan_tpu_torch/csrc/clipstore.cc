// Native clip-store batch assembler for the host-fed input path.
//
// Responsibilities:
//   * open a set of .npy files of uint8 frames (T, H, W, C), parse headers,
//     mmap the data (zero-copy; the page cache is the shuffle buffer),
//   * assemble a (B, T, H, W, C) uint8 batch from (clip_idx, start) pairs
//     with a single memcpy per run of frames, wrapping short clips modulo T.
//
// C ABI only, loaded with ctypes (mocogan_tpu_torch/data/native.py), which
// builds it at first use with
//   g++ -O3 -shared -fPIC -o libclipstore-<hash>.so clipstore.cc
// into mocogan_tpu_torch/build/.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Clip {
  const uint8_t* data = nullptr;  // first frame byte (past the npy header)
  int64_t frames = 0;
  void* map = nullptr;            // mmap base
  size_t map_len = 0;
};

struct Store {
  std::vector<Clip> clips;
  int64_t h = 0, w = 0, c = 0;    // uniform frame geometry
  int64_t frame_bytes = 0;
  std::string err;
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// Error-path teardown for cs_open: unmap every clip mapped so far (a
// corrupt file i > 0 must not leak mappings 0..i-1 for the process
// lifetime) and release the store.
void* fail_open(Store* st) {
  for (auto& clip : st->clips) {
    munmap(clip.map, clip.map_len);
  }
  delete st;
  return nullptr;
}

// Minimal .npy header parser for C-order uint8 arrays of rank 4.
bool parse_npy(const uint8_t* buf, size_t len, int64_t shape[4],
               size_t* data_off, std::string* why) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) {
    *why = "bad magic";
    return false;
  }
  const int major = buf[6];
  size_t hlen, hstart;
  if (major == 1) {
    hlen = buf[8] | (buf[9] << 8);
    hstart = 10;
  } else {  // 2.0/3.0: 4-byte little-endian header length
    if (len < 12) { *why = "short v2 header"; return false; }
    hlen = static_cast<size_t>(buf[8]) | (static_cast<size_t>(buf[9]) << 8) |
           (static_cast<size_t>(buf[10]) << 16) |
           (static_cast<size_t>(buf[11]) << 24);
    hstart = 12;
  }
  if (hstart + hlen > len) { *why = "truncated header"; return false; }
  std::string hdr(reinterpret_cast<const char*>(buf + hstart), hlen);
  if (hdr.find("'|u1'") == std::string::npos &&
      hdr.find("'uint8'") == std::string::npos) {
    *why = "dtype is not uint8: " + hdr;
    return false;
  }
  if (hdr.find("'fortran_order': False") == std::string::npos) {
    *why = "fortran order not supported";
    return false;
  }
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) { *why = "no shape"; return false; }
  sp = hdr.find('(', sp);
  size_t ep = hdr.find(')', sp);
  if (sp == std::string::npos || ep == std::string::npos) {
    *why = "bad shape tuple";
    return false;
  }
  std::string tup = hdr.substr(sp + 1, ep - sp - 1);
  int rank = 0;
  const char* p = tup.c_str();
  while (*p) {
    char* endp = nullptr;
    long long v = std::strtoll(p, &endp, 10);
    if (endp == p) break;
    if (rank == 4) {
      // A 5th dimension must REJECT the file, not truncate the shape:
      // frame_bytes computed from a truncated tuple would silently serve
      // byte-misaligned garbage as training data.
      *why = "rank > 4";
      return false;
    }
    if (v <= 0) { *why = "non-positive dimension"; return false; }
    shape[rank++] = static_cast<int64_t>(v);
    p = endp;
    while (*p == ',' || *p == ' ') ++p;
  }
  if (rank != 4) { *why = "rank != 4"; return false; }
  *data_off = hstart + hlen;
  return true;
}

}  // namespace

extern "C" {

void* cs_open(const char** paths, int n_paths, char* err, int errlen) {
  auto* st = new Store();
  for (int i = 0; i < n_paths; ++i) {
    int fd = ::open(paths[i], O_RDONLY);
    if (fd < 0) {
      set_err(err, errlen, std::string("open failed: ") + paths[i]);
      return fail_open(st);
    }
    struct stat sb;
    if (fstat(fd, &sb) != 0 || sb.st_size < 10) {
      ::close(fd);
      set_err(err, errlen, std::string("stat failed: ") + paths[i]);
      return fail_open(st);
    }
    void* map = mmap(nullptr, static_cast<size_t>(sb.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (map == MAP_FAILED) {
      set_err(err, errlen, std::string("mmap failed: ") + paths[i]);
      return fail_open(st);
    }
    madvise(map, static_cast<size_t>(sb.st_size), MADV_WILLNEED);

    int64_t shape[4];
    size_t off;
    std::string why;
    if (!parse_npy(static_cast<const uint8_t*>(map),
                   static_cast<size_t>(sb.st_size), shape, &off, &why)) {
      munmap(map, static_cast<size_t>(sb.st_size));
      set_err(err, errlen, std::string(paths[i]) + ": " + why);
      return fail_open(st);
    }
    if (st->clips.empty()) {
      st->h = shape[1];
      st->w = shape[2];
      st->c = shape[3];
      st->frame_bytes = st->h * st->w * st->c;
    } else if (shape[1] != st->h || shape[2] != st->w || shape[3] != st->c) {
      munmap(map, static_cast<size_t>(sb.st_size));
      set_err(err, errlen,
              std::string(paths[i]) + ": frame geometry differs from clip 0");
      return fail_open(st);
    }
    const size_t need = off + static_cast<size_t>(shape[0] * st->frame_bytes);
    if (need > static_cast<size_t>(sb.st_size)) {
      munmap(map, static_cast<size_t>(sb.st_size));
      set_err(err, errlen, std::string(paths[i]) + ": file shorter than shape");
      return fail_open(st);
    }
    Clip clip;
    clip.data = static_cast<const uint8_t*>(map) + off;
    clip.frames = shape[0];
    clip.map = map;
    clip.map_len = static_cast<size_t>(sb.st_size);
    st->clips.push_back(clip);
  }
  return st;
}

int cs_clip_count(void* h) {
  return static_cast<int>(static_cast<Store*>(h)->clips.size());
}

int64_t cs_clip_frames(void* h, int i) {
  return static_cast<Store*>(h)->clips[static_cast<size_t>(i)].frames;
}

void cs_dims(void* h, int64_t* hwc) {
  auto* st = static_cast<Store*>(h);
  hwc[0] = st->h;
  hwc[1] = st->w;
  hwc[2] = st->c;
}

// Fill out[b, t, h, w, c] with frames (start_j + k) % clip_frames.
int cs_fill_batch(void* h, const int32_t* clip_idx, const int64_t* starts,
                  int b, int t, uint8_t* out) {
  auto* st = static_cast<Store*>(h);
  const int64_t fb = st->frame_bytes;
  for (int j = 0; j < b; ++j) {
    const int ci = clip_idx[j];
    if (ci < 0 || ci >= static_cast<int>(st->clips.size())) return -1;
    const Clip& clip = st->clips[static_cast<size_t>(ci)];
    uint8_t* dst = out + static_cast<int64_t>(j) * t * fb;
    const int64_t n = clip.frames;
    int64_t pos = starts[j] % n;
    if (pos < 0) pos += n;
    int k = 0;
    while (k < t) {
      // contiguous run until clip end: one memcpy for the whole run
      const int64_t run = std::min<int64_t>(t - k, n - pos);
      std::memcpy(dst + static_cast<int64_t>(k) * fb,
                  clip.data + pos * fb, static_cast<size_t>(run * fb));
      k += static_cast<int>(run);
      pos = 0;
    }
  }
  return 0;
}

void cs_close(void* h) {
  auto* st = static_cast<Store*>(h);
  for (auto& clip : st->clips) {
    munmap(clip.map, clip.map_len);
  }
  delete st;
}

}  // extern "C"
