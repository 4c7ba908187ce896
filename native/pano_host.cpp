// pano_host: native host-side runtime for pano.
//
// The GPU compute path is JAX/XLA; this library is the native
// equivalent of the reference's host-side C++ runtime — its image reader
// static library (reference: src/reader/reader.cpp, the only shared C++
// component) plus the host utilities around it. Exposed as a plain C ABI
// consumed from Python via ctypes (no pybind11 in this environment).
//
// Functions:
//   ph_version()                       -> ABI version int
//   ph_imread_dims(path, &h, &w)       -> 0 ok / -1 unreadable
//   ph_imread_fill(path, buf, h, w)    -> decode BGR u8 into caller buffer
//   ph_imwrite(path, buf, h, w)        -> encode + write (extension-driven)
//   ph_read_dir(dir, paths_out, cap)   -> newline-joined sorted regular files
//
// Decoding goes through OpenCV's C++ imgcodecs exactly like cv::imread in
// the reference (reader.cpp:61), so byte-level pixel parity with the
// Python-side cv2 fallback is guaranteed (same library).

#include <algorithm>
#include <cstring>
#include <filesystem>
#include <string>
#include <vector>

#include <opencv2/imgcodecs.hpp>

namespace fs = std::filesystem;

extern "C" {

int ph_version() { return 2; }

// Returns 0 and fills h/w on success; -1 if the file cannot be decoded.
int ph_imread_dims(const char* path, int* h, int* w) {
  cv::Mat img = cv::imread(path, cv::IMREAD_COLOR);
  if (img.empty()) return -1;
  *h = img.rows;
  *w = img.cols;
  return 0;
}

// Decodes into caller-provided buffer of size h*w*3 (BGR, row-major).
// h/w are the dimensions the caller sized the buffer from (an earlier
// ph_imread_dims call); if this decode disagrees (file changed between the
// two calls) return -1 instead of overflowing the buffer.
int ph_imread_fill(const char* path, unsigned char* buf, int h, int w) {
  cv::Mat img = cv::imread(path, cv::IMREAD_COLOR);
  if (img.empty()) return -1;
  if (img.rows != h || img.cols != w) return -1;
  if (!img.isContinuous()) img = img.clone();
  std::memcpy(buf, img.data, static_cast<size_t>(img.total()) * 3);
  return 0;
}

int ph_imwrite(const char* path, const unsigned char* buf, int h, int w) {
  cv::Mat img(h, w, CV_8UC3, const_cast<unsigned char*>(buf));
  return cv::imwrite(path, img) ? 0 : -1;
}

// Writes a '\n'-joined, lexicographically sorted list of regular files in
// `dir` into `out` (capacity `cap`, NUL-terminated). Returns the number of
// files, or -1 if dir is invalid / the buffer is too small.
// (Deterministic ordering is a deliberate fix over the reference's
// unsorted fs::directory_iterator, reader.cpp:58.)
int ph_read_dir(const char* dir, char* out, long cap) {
  if (!fs::exists(dir) || !fs::is_directory(dir)) return -1;
  std::vector<std::string> names;
  for (const auto& entry : fs::directory_iterator(dir)) {
    if (entry.is_regular_file()) names.push_back(entry.path().string());
  }
  std::sort(names.begin(), names.end());
  std::string joined;
  for (const auto& n : names) {
    if (!joined.empty()) joined += '\n';
    joined += n;
  }
  if (static_cast<long>(joined.size()) + 1 > cap) return -1;
  std::memcpy(out, joined.c_str(), joined.size() + 1);
  return static_cast<int>(names.size());
}

}  // extern "C"
