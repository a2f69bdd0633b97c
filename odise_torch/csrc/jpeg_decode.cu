// JPEG decoding on the card with nvJPEG, behind a plain C interface that
// odise_torch/data/image_io.py loads with ctypes.
//
// Not a port of a TPU kernel: the JAX package decodes every image on the
// host through PIL (odise_tpu/data/dataset_mapper.py:60-75,
// tools/train_net.py:335-361). The port does not depend on PIL on the card:
// it decodes JPEGs with the CUDA toolkit's nvJPEG (Huffman decoding on the
// host, IDCT and colour conversion on the card) straight into a tensor on
// the card, on the caller's stream. One nvJPEG handle serves the process,
// made on the device current at the first call; image_io.py refuses a
// decode onto any other device. Each thread decodes with its own decoder
// state (nvJPEG's rule for threads: a handle may be shared, a state may
// not), made at its first decode and destroyed when the thread ends, so
// the eval loop's prefetch thread and the training thread decode at once.
// A thread that moves to another stream first waits for its previous
// decode, whose buffers in the state the next one reuses.
//
// Return codes: 0 on success, an nvjpegStatus_t (1 to 10) from nvJPEG, or
// 1000 + a cudaError_t from the launch check.

#include <cstring>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

static nvjpegHandle_t g_handle = nullptr;
static std::mutex g_handle_mutex;

struct ThreadDecoder {
  nvjpegJpegState_t state = nullptr;
  cudaEvent_t done = nullptr;        // recorded after this thread's last decode
  cudaStream_t stream = nullptr;     // the stream of that decode
  ~ThreadDecoder() {
    if (done != nullptr) {
      cudaEventSynchronize(done);
      cudaEventDestroy(done);
    }
    if (state != nullptr) nvjpegJpegStateDestroy(state);
  }
};
static thread_local ThreadDecoder t_decoder;

static int ensure_handle() {
  std::lock_guard<std::mutex> lock(g_handle_mutex);
  if (g_handle != nullptr) return 0;
  nvjpegHandle_t handle = nullptr;
  nvjpegStatus_t s = nvjpegCreateSimple(&handle);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  g_handle = handle;
  return 0;
}

static int ensure_decoder() {
  int err = ensure_handle();
  if (err) return err;
  if (t_decoder.state != nullptr) return 0;
  nvjpegStatus_t s = nvjpegJpegStateCreate(g_handle, &t_decoder.state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    t_decoder.state = nullptr;
    return static_cast<int>(s);
  }
  cudaError_t c = cudaEventCreateWithFlags(&t_decoder.done, cudaEventDisableTiming);
  if (c != cudaSuccess) {
    t_decoder.done = nullptr;
    nvjpegJpegStateDestroy(t_decoder.state);
    t_decoder.state = nullptr;
    return 1000 + static_cast<int>(c);
  }
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
// bytes apart), on `stream`, with the calling thread's decoder state.
extern "C" int jpeg_decode_rgbi(const unsigned char* data, size_t length, unsigned char* out,
                                int pitch, void* stream) {
  int err = ensure_decoder();
  if (err) return err;
  cudaStream_t cu_stream = static_cast<cudaStream_t>(stream);
  cudaError_t c;
  if (t_decoder.stream != cu_stream) {
    c = cudaEventSynchronize(t_decoder.done);  // a fresh event is complete
    if (c != cudaSuccess) return 1000 + static_cast<int>(c);
  }
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(pitch);
  nvjpegStatus_t s = nvjpegDecode(g_handle, t_decoder.state, data, length, NVJPEG_OUTPUT_RGBI,
                                  &image, cu_stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  c = cudaGetLastError();
  if (c != cudaSuccess) return 1000 + static_cast<int>(c);
  c = cudaEventRecord(t_decoder.done, cu_stream);
  if (c != cudaSuccess) return 1000 + static_cast<int>(c);
  t_decoder.stream = cu_stream;
  return 0;
}
