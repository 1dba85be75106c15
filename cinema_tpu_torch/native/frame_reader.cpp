// NIfTI frame reader in C++ and zlib, outside the Python interpreter (port of
// cinema_tpu/native/frame_reader.cpp, the same C API).
//
// The pretraining loader reads one random time frame per view of a study per
// item from 4-D .nii.gz cines. Python's gzip module inflates under the
// interpreter; these functions inflate in C++ (ctypes releases the interpreter
// lock around a call), and ct_read_at_batch decodes a batch of frames on
// threads of its own.
//
// C API (ctypes, see cinema_tpu_torch/native/__init__.py):
//   ct_probe(path, header*)                          the 348-byte header
//   ct_read_at(path, offset, nbytes, out*)           seek and read voxel bytes
//   ct_inflate_at(path, offset, clen, out*, nbytes)  inflate one gzip member
//   ct_read_at_batch(n, paths, offsets, nbytes, outs, n_threads)
//
// gzopen/gzseek/gzread read gzipped and raw files alike (zlib checks the
// magic), so one path serves .nii and .nii.gz.
//
// Little-endian only, as the JAX package's reader: the header's fields are
// copied as they lie in the file, which is what a NIfTI-1 file written on
// a little-endian host holds, and every host this runs on (x86-64, aarch64) is
// little-endian.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

// Frame offsets in large 4-D studies can pass 2 GB; with a 32-bit z_off_t the
// gzseek below would wrap and read the wrong frame. Refuse to build then (the
// port then reads with Python, which handles 64-bit offsets).
static_assert(sizeof(z_off_t) == 8, "zlib built without large-file support (32-bit z_off_t)");

extern "C" {

typedef struct {
  int64_t ndim;
  int64_t shape[7];
  int32_t datatype;
  int32_t bitpix;
  int64_t vox_offset;
  float scl_slope;
  float scl_inter;
} CtNiftiHeader;

enum {
  CT_OK = 0,
  CT_ERR_OPEN = 1,
  CT_ERR_READ = 2,
  CT_ERR_MAGIC = 3,
  CT_ERR_SEEK = 4,
};

static int16_t rd_i16(const unsigned char* b) {
  int16_t v;
  std::memcpy(&v, b, 2);  // little-endian file on a little-endian host
  return v;
}

static float rd_f32(const unsigned char* b) {
  float v;
  std::memcpy(&v, b, 4);
  return v;
}

int ct_probe(const char* path, CtNiftiHeader* out) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return CT_ERR_OPEN;
  unsigned char hdr[348];
  int n = gzread(f, hdr, 348);
  gzclose(f);
  if (n != 348) return CT_ERR_READ;
  if (std::memcmp(hdr + 344, "n+1", 3) != 0 && std::memcmp(hdr + 344, "ni1", 3) != 0) return CT_ERR_MAGIC;
  int16_t ndim = rd_i16(hdr + 40);
  if (ndim < 1 || ndim > 7) return CT_ERR_MAGIC;
  out->ndim = ndim;
  for (int i = 0; i < 7; ++i) out->shape[i] = (i < ndim) ? rd_i16(hdr + 42 + 2 * i) : 1;
  out->datatype = rd_i16(hdr + 70);
  out->bitpix = rd_i16(hdr + 72);
  out->vox_offset = (int64_t)rd_f32(hdr + 108);
  out->scl_slope = rd_f32(hdr + 112);
  out->scl_inter = rd_f32(hdr + 116);
  return CT_OK;
}

int ct_read_at(const char* path, int64_t offset, int64_t nbytes, unsigned char* out) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return CT_ERR_OPEN;
  gzbuffer(f, 1 << 18);  // 256 KiB: fewer inflate calls over the skipped prefix
  if (gzseek(f, (z_off_t)offset, SEEK_SET) < 0) {
    gzclose(f);
    return CT_ERR_SEEK;
  }
  int64_t done = 0;
  while (done < nbytes) {
    unsigned chunk = (unsigned)((nbytes - done) > (1 << 30) ? (1 << 30) : (nbytes - done));
    int n = gzread(f, out + done, chunk);
    if (n <= 0) {
      gzclose(f);
      return CT_ERR_READ;
    }
    done += n;
  }
  gzclose(f);
  return CT_OK;
}

// Inflate the one gzip member at the byte range [offset, offset + clen) of the
// file into exactly nbytes: a frame of a frame-indexed .nii.gz (one member per
// frame, their offsets in an FEXTRA field of member 0). No skip over the
// members before it.
int ct_inflate_at(const char* path, int64_t offset, int64_t clen, unsigned char* out, int64_t nbytes) {
  FILE* fp = std::fopen(path, "rb");
  if (fp == nullptr) return CT_ERR_OPEN;
  std::vector<unsigned char> comp((size_t)clen);
  if (std::fseek(fp, (long)offset, SEEK_SET) != 0 || std::fread(comp.data(), 1, (size_t)clen, fp) != (size_t)clen) {
    std::fclose(fp);
    return CT_ERR_READ;
  }
  std::fclose(fp);
  z_stream strm;
  std::memset(&strm, 0, sizeof(strm));
  if (inflateInit2(&strm, 31) != Z_OK) return CT_ERR_READ;  // 31: a gzip wrapper
  strm.next_in = comp.data();
  strm.avail_in = (uInt)clen;
  strm.next_out = out;
  strm.avail_out = (uInt)nbytes;
  int rc = inflate(&strm, Z_FINISH);
  int64_t got = (int64_t)strm.total_out;
  inflateEnd(&strm);
  return (rc == Z_STREAM_END && got == nbytes) ? CT_OK : CT_ERR_READ;
}

int ct_read_at_batch(int64_t n, const char** paths, const int64_t* offsets, const int64_t* nbytes,
                     unsigned char** outs, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int> rcs((size_t)n, CT_OK);
  std::vector<std::thread> pool;
  // a static split: thread t reads items t, t + T, t + 2T, ...
  for (int64_t t = 0; t < n_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += n_threads) rcs[(size_t)i] = ct_read_at(paths[i], offsets[i], nbytes[i], outs[i]);
    });
  }
  for (auto& th : pool) th.join();
  for (int64_t i = 0; i < n; ++i)
    if (rcs[(size_t)i] != CT_OK) return rcs[(size_t)i];
  return CT_OK;
}

}  // extern "C"
