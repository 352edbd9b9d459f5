// Binary PLY point-cloud writer (host library of diner_tpu_torch.fusion.ply).
//
// Behavioral reference: storePlyFileBinaryPointCloud in
// deps/TransMVSNet/deps/fusibile/main.cpp:843 of malteprinzler/diner (the
// reference's CUDA fusion executable serializes fused points as binary
// little-endian PLY with x/y/z float32 + r/g/b uchar [+ nx/ny/nz float32]).
//
// Exposed via a C ABI for ctypes; built at its first use by
// diner_tpu_torch/kernels/build.py:host_library (c++ -shared).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Writes a binary_little_endian PLY. Returns 0 on success.
//   path:    output file
//   n:       number of points
//   xyz:     n*3 float32
//   rgb:     n*3 uint8 (nullable)
//   normals: n*3 float32 (nullable)
int write_ply_binary(const char* path, int64_t n, const float* xyz,
                     const uint8_t* rgb, const float* normals) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;

  std::string header = "ply\nformat binary_little_endian 1.0\n";
  header += "element vertex " + std::to_string(n) + "\n";
  header += "property float x\nproperty float y\nproperty float z\n";
  if (normals)
    header += "property float nx\nproperty float ny\nproperty float nz\n";
  if (rgb)
    header +=
        "property uchar red\nproperty uchar green\nproperty uchar blue\n";
  header += "end_header\n";
  if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
    std::fclose(f);
    return 2;
  }

  // Row-interleaved record assembly in a buffered chunk loop (the hot part —
  // this is why the writer is native: ~n*15..27 bytes of packing).
  const size_t rec =
      3 * sizeof(float) + (normals ? 3 * sizeof(float) : 0) + (rgb ? 3 : 0);
  const int64_t kChunk = 1 << 16;
  std::vector<uint8_t> buf(static_cast<size_t>(kChunk) * rec);
  for (int64_t start = 0; start < n; start += kChunk) {
    const int64_t m = (n - start) < kChunk ? (n - start) : kChunk;
    uint8_t* p = buf.data();
    for (int64_t i = 0; i < m; ++i) {
      const int64_t j = start + i;
      std::memcpy(p, xyz + 3 * j, 3 * sizeof(float));
      p += 3 * sizeof(float);
      if (normals) {
        std::memcpy(p, normals + 3 * j, 3 * sizeof(float));
        p += 3 * sizeof(float);
      }
      if (rgb) {
        std::memcpy(p, rgb + 3 * j, 3);
        p += 3;
      }
    }
    if (std::fwrite(buf.data(), 1, static_cast<size_t>(m) * rec, f) !=
        static_cast<size_t>(m) * rec) {
      std::fclose(f);
      return 3;
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
