// Host-side data kernels of the port's input pipeline: an IDX decoder and
// a multithreaded uint8 -> float32 normaliser (the C++ data path the
// reference takes through torchvision and DataLoader,
// `mnist/data_utils.py:15,27`).  Loaded through ctypes by
// cfgan_torch/native/__init__.py, which builds it with g++ into the
// compile cache; cfgan_torch/data/mnist.py keeps the plain numpy versions
// the tests hold these against.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Parse an (uncompressed) IDX file: header = 0x00 0x00 <dtype> <ndim>
// followed by ndim big-endian uint32 dims, then the payload.
// Returns 0 on success; fills dims[0..ndim) and copies payload into `out`
// (caller allocates out_cap bytes).  Negative codes: -1 open, -2 header,
// -3 unsupported dtype (only uint8 = 0x08), -4 out buffer too small,
// -5 truncated payload.
int idx_read(const char* path, unsigned char* out, long long out_cap,
             long long* dims, int* ndim_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char header[4];
  if (std::fread(header, 1, 4, f) != 4 || header[0] != 0 || header[1] != 0) {
    std::fclose(f);
    return -2;
  }
  if (header[2] != 0x08) {  // uint8 payloads only (MNIST images/labels)
    std::fclose(f);
    return -3;
  }
  int ndim = header[3];
  // The caller passes an 8-slot dims array; ndim is a file-controlled byte,
  // so anything larger is both malformed (MNIST IDX is 1-3 dims) and an
  // out-of-bounds write hazard.  Reject instead of trusting it.
  if (ndim < 1 || ndim > 8) {
    std::fclose(f);
    return -2;
  }
  long long total = 1;
  for (int i = 0; i < ndim; ++i) {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) {
      std::fclose(f);
      return -2;
    }
    long long d = ((long long)b[0] << 24) | ((long long)b[1] << 16) |
                  ((long long)b[2] << 8) | (long long)b[3];
    dims[i] = d;
    // Guard total *= d against signed overflow before multiplying.
    if (d != 0 && total > (0x7fffffffffffffffLL / d)) {
      std::fclose(f);
      return -2;
    }
    total *= d;
  }
  *ndim_out = ndim;
  if (total > out_cap) {
    std::fclose(f);
    return -4;
  }
  long long got = (long long)std::fread(out, 1, (size_t)total, f);
  std::fclose(f);
  return got == total ? 0 : -5;
}

// uint8 -> float32 with (x/255 - mean)/std normalization, multithreaded.
// The hot host-side transform of the input pipeline (python equivalent:
// cfgan_torch.data.mnist.normalize_plain).  Only 256 input values exist, so
// a lookup table built with the EXACT python rounding sequence
// ((x / 255) - mean) / stddev keeps this path bit-identical to the numpy
// version (a fused scale+shift rounds differently by ~1 ulp) while also
// replacing two flops per element with one load.
void u8_to_f32_norm(const unsigned char* in, float* out, long long n,
                    float mean, float stddev) {
  float lut[256];
  for (int v = 0; v < 256; ++v) {
    lut[v] = (((float)v / 255.0f) - mean) / stddev;
  }
  int workers = (int)std::thread::hardware_concurrency();
  if (workers < 1) workers = 1;
  if (n < (1 << 20)) workers = 1;  // small arrays: threading overhead loses
  std::vector<std::thread> threads;
  long long chunk = (n + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    long long lo = w * chunk;
    long long hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=] {
      for (long long i = lo; i < hi; ++i) {
        out[i] = lut[in[i]];
      }
    });
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
