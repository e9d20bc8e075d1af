// Bit-packed sea-of-gates circuit evaluation for Hopper (sm_90a).
//
// Two __global__s, one per TPU kernel of the reference package:
//
//   eval_population_kernel        replaces src/repro/kernels/circuit_eval.py
//                                 eval_population_kernel (body _kernel)
//   eval_population_spans_kernel  replaces src/repro/kernels/circuit_eval.py
//                                 eval_population_spans_kernel (body _spans_kernel)
//
// What they compute.  Dataset rows are packed 32 to a 32-bit word; bit j of
// word w is row 32*w + j.  Circuit p walks its n gates in topological order
// (gate i reads ids < I + i) and copies its O output taps:
//   population: out[p][o][w] over the shared words x[I][W];
//   spans:      circuit p reads only words [word_off[p], word_off[p] + span)
//               of the fused buffer x[I_max][W_total], with input rows
//               >= in_width[p] read as zero (tenant isolation).  Offsets
//               follow the reference's dynamic_slice, so any offset is
//               served: a negative one counts from the buffer's end, then a
//               window that would run off either end is clamped into it.
// An operand or tap id outside the genome contract (gate i: [0, I+i);
// taps: [0, I+n)) reads a zero word: a corrupt genome never reads anything
// but its own circuit's values.
//
// Design.  One thread per packed word; one CTA per (circuit p, run of T
// words), grid (ceil(W/T), P).  The genome of circuit p is the same for the
// whole CTA, so it is staged in shared memory once, the switch on the opcode
// never diverges, and operand ids are broadcasts.  Only the n gate outputs
// live in shared memory, as [n][T] words with thread t owning column t:
// consecutive threads hit consecutive banks (no conflicts) and no thread
// ever reads another's column, so the gate loop needs no barrier.  Input
// operands are read straight from global memory (read-only, coalesced
// across the warp, L2-resident at serving sizes): keeping all I + n rows in
// shared memory, as the TPU kernel kept them in VMEM, would not fit a CTA's
// 227 KB at I = 476, n = 300, T = 128.  The wrapper sizes T from n.
//
// What bounds it on this card.  Each gate is two dependent operand loads, one
// logic op and one shared-memory store, so the loop is bound by shared-memory
// latency along a chain of n gates per thread, not by bytes (x is read once
// per operand use from L1/L2) nor by integer throughput.  With n = 300 a CTA
// holds 157 KB of gate table, so one CTA (T = 128 threads, 4 warps) fits an
// SM: few warps hide little latency.  Staging x with cp.async/TMA and taking
// more words per thread are the next steps; this version is the simple one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kZero = -1;  // operand code: reads an all-zero word

__device__ __forceinline__ uint32_t apply_gate(int op, uint32_t a, uint32_t b) {
  switch (op) {  // opcode table of core/gates.py; order is load-bearing
    case 0: return a & b;      // AND
    case 1: return a | b;      // OR
    case 2: return ~(a & b);   // NAND
    case 3: return ~(a | b);   // NOR
    case 4: return a ^ b;      // XOR
    case 5: return ~(a ^ b);   // XNOR
    case 6: return ~a;         // NOT_A
    case 7: return a;          // BUF_A
    default: return 0u;        // the reference's select chain yields 0
  }
}

// Map an id to its operand code: an input row in [0, width), a gate id in
// [n_in, limit), or kZero for anything else (masked input rows included).
__device__ __forceinline__ int operand_code(int id, int n_in, int width, int limit) {
  if (id < 0 || id >= limit) return kZero;
  if (id < n_in && id >= width) return kZero;
  return id;
}

// One CTA: circuit p over output words [blockIdx.x * T, +T).
//   xcol: x + first column of this circuit's window; x_ld: row stride of x.
__device__ __forceinline__ void eval_cta(
    const int* __restrict__ opcodes, const int* __restrict__ edge_src,
    const int* __restrict__ out_src, const uint32_t* __restrict__ xcol,
    uint32_t* __restrict__ out, int p, int n, int n_out, int n_in, int width,
    long long x_ld, int out_w) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  uint32_t* gtab = smem;                                   // [n][T]
  int* s_op = reinterpret_cast<int*>(smem + (size_t)n * T);  // [n]
  int* s_edge = s_op + n;                                  // [n][2]
  int* s_tap = s_edge + 2 * n;                             // [O]

  const int* op_p = opcodes + (size_t)p * n;
  const int* edge_p = edge_src + (size_t)p * n * 2;
  const int* tap_p = out_src + (size_t)p * n_out;
  for (int k = t; k < n; k += T) {
    s_op[k] = op_p[k];
    s_edge[2 * k] = operand_code(edge_p[2 * k], n_in, width, n_in + k);
    s_edge[2 * k + 1] = operand_code(edge_p[2 * k + 1], n_in, width, n_in + k);
  }
  for (int k = t; k < n_out; k += T) {
    s_tap[k] = operand_code(tap_p[k], n_in, width, n_in + n);
  }
  __syncthreads();

  const int w = blockIdx.x * T + t;
  if (w >= out_w) return;  // ragged word edge: no padding copy of x
  const uint32_t* xw = xcol + w;
  uint32_t* gcol = gtab + t;

  auto load = [&](int code) -> uint32_t {
    if (code < 0) return 0u;
    if (code < n_in) return __ldg(xw + (long long)code * x_ld);
    return gcol[(size_t)(code - n_in) * T];
  };

  for (int i = 0; i < n; ++i) {
    const uint32_t a = load(s_edge[2 * i]);
    const uint32_t b = load(s_edge[2 * i + 1]);
    gcol[(size_t)i * T] = apply_gate(s_op[i], a, b);
  }
  uint32_t* out_p = out + (size_t)p * n_out * out_w + w;
  for (int j = 0; j < n_out; ++j) {
    out_p[(size_t)j * out_w] = load(s_tap[j]);
  }
}

__global__ void eval_population_kernel(
    const int* __restrict__ opcodes, const int* __restrict__ edge_src,
    const int* __restrict__ out_src, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ out, int n, int n_out, int n_in, int w) {
  eval_cta(opcodes, edge_src, out_src, x, out, blockIdx.y, n, n_out, n_in,
           n_in, w, w);
}

__global__ void eval_population_spans_kernel(
    const int* __restrict__ opcodes, const int* __restrict__ edge_src,
    const int* __restrict__ out_src, const uint32_t* __restrict__ x,
    const int* __restrict__ word_off, const int* __restrict__ in_width,
    uint32_t* __restrict__ out, int n, int n_out, int n_in, int w_total,
    int span) {
  const int p = blockIdx.y;
  int off = word_off[p];
  if (off < 0) off += w_total;
  off = min(max(off, 0), w_total - span);
  const int width = min(max(in_width[p], 0), n_in);
  eval_cta(opcodes, edge_src, out_src, x + off, out, p, n, n_out, n_in,
           width, w_total, span);
}

size_t smem_bytes(int n, int n_out, int threads) {
  return sizeof(uint32_t) * ((size_t)n * threads + 3 * (size_t)n + n_out);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

bool bad_shape(int pop, int n, int n_out, int n_in, int words, int threads) {
  return pop < 1 || pop > 65535 || n < 1 || n_out < 1 || n_in < 1 ||
         words < 1 || threads < 32 || threads > 1024 || threads % 32 != 0;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 on success).  The caller allocates `out` and checks shapes.
int circuit_eval_population(const int* opcodes, const int* edge_src,
                            const int* out_src, const int* x, int* out,
                            int pop, int n, int n_out, int n_in, int w,
                            int threads, void* stream) {
  if (bad_shape(pop, n, n_out, n_in, w, threads)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, n_out, threads);
  cudaError_t err = prepare(eval_population_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + threads - 1) / threads, pop);
  eval_population_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      opcodes, edge_src, out_src, reinterpret_cast<const uint32_t*>(x),
      reinterpret_cast<uint32_t*>(out), n, n_out, n_in, w);
  return cudaGetLastError();
}

int circuit_eval_population_spans(const int* opcodes, const int* edge_src,
                                  const int* out_src, const int* x,
                                  const int* word_off, const int* in_width,
                                  int* out, int pop, int n, int n_out,
                                  int n_in, int w_total, int span,
                                  int threads, void* stream) {
  if (bad_shape(pop, n, n_out, n_in, span, threads) || span > w_total) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(n, n_out, threads);
  cudaError_t err = prepare(eval_population_spans_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((span + threads - 1) / threads, pop);
  eval_population_spans_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      opcodes, edge_src, out_src, reinterpret_cast<const uint32_t*>(x),
      word_off, in_width, reinterpret_cast<uint32_t*>(out), n, n_out, n_in,
      w_total, span);
  return cudaGetLastError();
}

const char* circuit_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
