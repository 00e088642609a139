// Flash attention's decode regime for bf16 operands: the kernel of
// flash_decode.cuh (its header says what it replaces, what bounds it and
// how it is laid out), built for __nv_bfloat16.
#include "flash_decode.cuh"

extern "C" int qappa_flash_decode(const void* q, const void* k, const void* v,
                                  void* out, const long long* strides,
                                  void* scratch, long long scratch_len,
                                  void* workspace, long long workspace_len,
                                  int b, int h, int kvh, int sq, int sk, int d,
                                  int causal, int window, float scale,
                                  int key_lo, int split_keys, int rt,
                                  int slices, int* info, void* stream) {
  return flash_decode_entry<__nv_bfloat16>(
      q, k, v, out, strides, scratch, scratch_len, workspace, workspace_len,
      b, h, kvh, sq, sk, d, causal, window, scale, key_lo, split_keys, rt,
      slices, info, stream);
}

extern "C" const char* qappa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
