// JPEG decoding on the card with nvJPEG, behind a plain C interface that
// odise_torch/data/image_io.py loads with ctypes.
//
// Not a port of a TPU kernel: the JAX package decodes every image on the
// host through PIL (odise_tpu/data/dataset_mapper.py:60-75,
// tools/train_net.py:335-361). The port does not depend on PIL on the card:
// it decodes JPEGs with the CUDA toolkit's nvJPEG (Huffman decoding on the
// host, IDCT and colour conversion on the card) straight into a tensor on
// the card, on the caller's stream. One nvJPEG handle and decoder state
// serve the process, made on the device current at the first call;
// image_io.py refuses a decode onto any other device. The functions are not
// thread-safe.
//
// Return codes: 0 on success, an nvjpegStatus_t (1 to 10) from nvJPEG, or
// 1000 + a cudaError_t from the launch check.

#include <cstring>

#include <cuda_runtime.h>
#include <nvjpeg.h>

static nvjpegHandle_t g_handle = nullptr;
static nvjpegJpegState_t g_state = nullptr;

static int ensure_handle() {
  if (g_handle != nullptr) return 0;
  nvjpegHandle_t handle = nullptr;
  nvjpegStatus_t s = nvjpegCreateSimple(&handle);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  nvjpegJpegState_t state = nullptr;
  s = nvjpegJpegStateCreate(handle, &state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(handle);
    return static_cast<int>(s);
  }
  g_handle = handle;
  g_state = state;
  return 0;
}

// The image's size (of component 0, the full-resolution one), its
// component count and nvJPEG's chroma subsampling code.
extern "C" int jpeg_image_info(const unsigned char* data, size_t length, int* width,
                               int* height, int* components, int* subsampling) {
  int err = ensure_handle();
  if (err) return err;
  int n = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, length, &n, &ss, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  *width = widths[0];
  *height = heights[0];
  *components = n;
  *subsampling = static_cast<int>(ss);
  return 0;
}

// Decode into interleaved RGB uint8 at `out` (device memory, rows `pitch`
// bytes apart), on `stream`.
extern "C" int jpeg_decode_rgbi(const unsigned char* data, size_t length, unsigned char* out,
                                int pitch, void* stream) {
  int err = ensure_handle();
  if (err) return err;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(pitch);
  nvjpegStatus_t s = nvjpegDecode(g_handle, g_state, data, length, NVJPEG_OUTPUT_RGBI, &image,
                                  static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  cudaError_t c = cudaGetLastError();
  return c == cudaSuccess ? 0 : 1000 + static_cast<int>(c);
}
