/* The native runner's C ABI (aoti_runner.cc): serves an AOTInductor
 * package (a forward, or a decode's init or step) with no Python. The
 * counterpart of the JAX package's PJRT runner ABI (paddle_tpu/native/
 * capi.h ptpu_pjrt_*), with the port's own copy of its typed tensor
 * layout and element types. */

#ifndef PTPU_AOTI_CAPI_H_
#define PTPU_AOTI_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Element types of ptpu_aoti_tensor.dtype (the values of the PJRT
 * runner's PTPU_DT_*, then the port's own: bf16, whose bits are the high
 * half of a float32's). */
enum {
  PTPU_AOTI_F32 = 0,
  PTPU_AOTI_I32 = 1,
  PTPU_AOTI_I64 = 2,
  PTPU_AOTI_PRED = 3,
  PTPU_AOTI_U8 = 4,
  PTPU_AOTI_F64 = 5,
  PTPU_AOTI_BF16 = 6
};

#define PTPU_AOTI_MAX_RANK 8

/* One typed host tensor crossing the ABI (ptpu_pjrt_tensor's layout).
 * Arguments:  dtype/rank/dims/data describe the value; size_bytes is its
 *             byte length (checked against dims).
 * Results:    data/size_bytes give a caller-owned capacity buffer; on
 *             return dtype/rank/dims describe the result and size_bytes
 *             the bytes written, or, where ptpu_aoti_execute_n returns
 *             -2, the bytes required. */
typedef struct {
  int32_t dtype;
  int32_t rank;
  int64_t dims[PTPU_AOTI_MAX_RANK];
  void* data;
  int64_t size_bytes;
} ptpu_aoti_tensor;

/* Load the package at `package_path` to run on `device` ("cpu", "cuda" or
 * "cuda:N"). NULL on error (ptpu_aoti_last_error): no such file, a
 * package compiled for another device, no CUDA device, a package without
 * the port's signature, an op of the package that is not registered. */
void* ptpu_aoti_create(const char* package_path, const char* device);

/* Number of results of the package (-1 for a NULL handle). */
int ptpu_aoti_num_outputs(void* h);

/* Run the package: num_args typed args in its signature's order (dtype,
 * rank and fixed dims checked; the batch "b" one size across them),
 * num_results result buffers (at most the package's results; trailing
 * ones are dropped). Returns 0 on success, -1 on error
 * (ptpu_aoti_last_error), -2 when some result's capacity was too small
 * (every result still describes what it needs). */
int ptpu_aoti_execute_n(void* h, const ptpu_aoti_tensor* args,
                        int32_t num_args, ptpu_aoti_tensor* results,
                        int32_t num_results);

void ptpu_aoti_destroy(void* h);

/* The calling thread's last error message. */
const char* ptpu_aoti_last_error(void);

/* Call the op `op` ("paddle_tpu_torch::lstm_fwd", say) as this process
 * registers it, on `device`, with no package: the tests' and
 * chip_smoke.py's way to hold the C++ ops to their Python twins on any
 * inputs. Its schema's arguments in order: each Tensor or Tensor? is the
 * next of `args` (a Tensor? is None where that tensor's data is NULL),
 * each int or bool the next of `scalars`. Returns the number of the op's
 * results (the first num_results of them written, as by
 * ptpu_aoti_execute_n), -1 on error, -2 where a result's capacity was too
 * small (the op ran). */
int ptpu_aoti_call_op(const char* op, const char* device,
                      const ptpu_aoti_tensor* args, int32_t num_args,
                      const int64_t* scalars, int32_t num_scalars,
                      ptpu_aoti_tensor* results, int32_t num_results);

/* Launches of a kernel by this process's ops (torch_ops.cc): "fused_lstm",
 * "fused_gru" or "fused_gru_cluster"; or the calls of an op's CPU
 * implementation, "lstm_fwd_cpu" or "gru_fwd_cpu"; -1 for another name. */
int64_t ptpu_aoti_launches(const char* kernel);

#ifdef __cplusplus
}
#endif

#endif /* PTPU_AOTI_CAPI_H_ */
