// Bit-packed sea-of-gates circuit evaluation for Hopper (sm_90a).
//
// Two __global__s, one per TPU kernel of the reference package, around one
// device body (eval_tile):
//
//   eval_program_kernel        replaces src/repro/kernels/circuit_eval.py
//                              eval_population_kernel (body _kernel)
//   eval_program_spans_kernel  replaces src/repro/kernels/circuit_eval.py
//                              eval_population_spans_kernel (body _spans_kernel)
//
// What they compute.  Dataset rows are packed 32 to a 32-bit word; bit j of
// word w is row 32*w + j.  Both run live-gate programs (kernels/program.py):
// circuit c stages the n_rows[c] input rows it reads, walks its n_live[c]
// live gates in topological order and copies its O taps, all as codes into
// one value table: [0, R) staged rows, [R, R+L) gates, R+L a zero word.  The
// host compiler has already applied the reference's id semantics (negative
// ids wrap once, then clamp; an operand not yet written reads zero; an
// opcode outside the table yields zero), so every code here is in range.
//   program: out[p][o][w] over the shared words x[I][W];
//   spans:   launch slot k runs circuit c = slots[k] (landed as the
//            reference's gather lands it) over the words
//            [word_off[k], word_off[k] + span) of the fused buffer
//            x[I_max][W_total]; input rows >= in_width[c] * live[k] read
//            as zero (tenant isolation; live = 0 marks a pad slot).
//            Offsets follow the reference's dynamic_slice: a negative one
//            counts from the buffer's end, then the window is clamped in.
//
// Design.  One CTA per (circuit, tile of T words), one thread per word,
// grid (ceil(W/T), P).  The program of circuit c is the same for the whole
// CTA, so its gate codes sit in shared memory, the switch on the opcode
// never diverges and operand reads are broadcasts of the code.
//   1. Staging: the CTA copies its R staged rows over its tile into the
//      table with cp.async (16-byte copies where the tile's first word and
//      the row stride are 16-byte aligned, as at the tick's power-of-two
//      spans; 4-byte copies otherwise, as at predict's W = 3,065).  A row at
//      or past the width is written as zeros, so the width test stays out
//      of the gate loop.  One barrier follows.
//   2. Gate loop: only the live gates, only shared memory.  The table is
//      [R+L+1][T] with thread t owning column t: consecutive threads hit
//      consecutive banks, no thread reads another's column, so the loop
//      needs no barrier.
//   3. Taps: each output word is one shared read and one coalesced store.
// The wrapper picks T in {128, 64, 32} as the largest that still gives at
// least two CTAs per SM, else 32, and as large as the table leaves room
// for in 227 KB.
//
// What bounds it on this card.  At serving sizes the bound (each input row
// read once, each output word written once) is tens of nanoseconds, far
// below a launch, so the time is the launch plus one CTA's latency chain:
// the dependent global reads before staging (slot, program sizes, row ids,
// words), one cp.async round trip, and the live gates' shared-memory chain.
// Compaction keeps that chain to the live gates (a few percent of n at the
// fitted bundles), staging keeps global reads off it, and the small table
// lets many CTAs share an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodeBits = 14;  // packed gate: op | a << 4 | b << 18
constexpr uint32_t kCodeMask = (1u << kCodeBits) - 1;

struct Program {
  const int* gates;   // [P][L][3] (opcode, code a, code b)
  const int* n_live;  // [P]
  const int* rows;    // [P][R]
  const int* n_rows;  // [P]
  const int* taps;    // [P][O]
  int pop, n_gates, n_rows_max, n_out;
};

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
    default: return 0u;        // program.ZERO_GATE
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One CTA: circuit c over words [blockIdx.x * T, +T) of a window of out_w
// words whose first column is xwin (row stride x_ld); rows >= width read 0.
// out points at this circuit's [O][out_w] block.
__device__ __forceinline__ void eval_tile(
    const Program& prog, int c, const uint32_t* __restrict__ xwin,
    long long x_ld, int out_w, int width, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int n_r = prog.n_rows_max, n_l = prog.n_gates, n_out = prog.n_out;
  uint32_t* tab = smem;                                     // [R+L+1][T]
  uint32_t* s_gate = smem + (size_t)(n_r + n_l + 1) * T;    // [L]
  int* s_tap = reinterpret_cast<int*>(s_gate + n_l);        // [O]

  const int w0 = blockIdx.x * T;
  const int valid = min(T, out_w - w0);  // words of the tile in the window
  const uint32_t* xt = xwin + w0;
  const int nr = prog.n_rows[c];
  const int* rows = prog.rows + (size_t)c * n_r;

  // 1. staging, asynchronous
  const bool vec16 =
      ((reinterpret_cast<uintptr_t>(xt) & 15) == 0) && ((x_ld & 3) == 0);
  if (vec16) {
    const int q = T / 4;  // 16-byte chunks per staged row
    for (int idx = t; idx < nr * q; idx += T) {
      const int j = idx / q;
      const int w = (idx - j * q) * 4;
      const int row = rows[j];
      uint32_t* dst = tab + (size_t)j * T + w;
      if (row >= width) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else if (w + 4 <= valid) {
        cp_async16(dst, xt + row * x_ld + w);
      } else {
        for (int u = w; u < valid; ++u) cp_async4(tab + (size_t)j * T + u, xt + row * x_ld + u);
      }
    }
  } else if (t < valid) {
    for (int j = 0; j < nr; ++j) {
      const int row = rows[j];
      if (row >= width) {
        tab[(size_t)j * T + t] = 0u;
      } else {
        cp_async4(tab + (size_t)j * T + t, xt + row * x_ld + t);
      }
    }
  }
  // the program, while the copies fly
  const int nl = prog.n_live[c];
  const int* g = prog.gates + (size_t)c * n_l * 3;
  for (int j = t; j < nl; j += T) {
    s_gate[j] = (uint32_t)g[3 * j] | ((uint32_t)g[3 * j + 1] << 4) |
                ((uint32_t)g[3 * j + 2] << (4 + kCodeBits));
  }
  for (int o = t; o < n_out; o += T) s_tap[o] = prog.taps[(size_t)c * n_out + o];
  tab[(size_t)(n_r + n_l) * T + t] = 0u;  // the zero code's word
  cp_async_wait_all();
  __syncthreads();

  if (t >= valid) return;  // ragged edge of the window
  uint32_t* col = tab + t;
  // 2. the live gates
  for (int j = 0; j < nl; ++j) {
    const uint32_t gj = s_gate[j];
    const uint32_t a = col[(size_t)((gj >> 4) & kCodeMask) * T];
    const uint32_t b = col[(size_t)(gj >> (4 + kCodeBits)) * T];
    col[(size_t)(n_r + j) * T] = apply_gate(gj & 15u, a, b);
  }
  // 3. the taps
  uint32_t* o_w = out + w0 + t;
  for (int o = 0; o < n_out; ++o) o_w[(size_t)o * out_w] = col[(size_t)s_tap[o] * T];
}

__global__ void eval_program_kernel(Program prog, const uint32_t* __restrict__ x,
                                    uint32_t* __restrict__ out, int n_in, int w) {
  const int p = blockIdx.y;
  eval_tile(prog, p, x, w, w, n_in, out + (size_t)p * prog.n_out * w);
}

__global__ void eval_program_spans_kernel(
    Program prog, const uint32_t* __restrict__ x, const int* __restrict__ slots,
    const int* __restrict__ word_off, const int* __restrict__ in_width,
    const int* __restrict__ live, uint32_t* __restrict__ out, int n_in,
    int w_total, int span) {
  const int k = blockIdx.y;
  int c = slots[k];  // the reference's gather: wrap once, then clamp
  if (c < 0) c += prog.pop;
  c = min(max(c, 0), prog.pop - 1);
  int off = word_off[k];
  if (off < 0) off += w_total;
  off = min(max(off, 0), w_total - span);
  // in_width[c] * live[k] in int32 with wrap-around, as the reference
  const int width = (int)((unsigned)in_width[c] * (unsigned)live[k]);
  eval_tile(prog, c, x + off, w_total, span, min(max(width, 0), n_in),
            out + (size_t)k * prog.n_out * span);
}

size_t smem_bytes(int n_gates, int n_rows_max, int n_out, int threads) {
  return sizeof(uint32_t) *
         ((size_t)(n_rows_max + n_gates + 1) * threads + n_gates + n_out);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic smem
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

bool bad_program(int pop, int n_gates, int n_rows_max, int n_out, int n_in,
                 int words, int threads) {
  return pop < 1 || n_gates < 0 || n_rows_max < 0 || n_out < 1 || n_in < 1 ||
         words < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
         n_rows_max + n_gates + 1 > (int)kCodeMask;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 on success).  The caller allocates `out` and checks shapes.
int circuit_eval_program(const int* gates, const int* n_live, const int* rows,
                         const int* n_rows, const int* taps, int pop,
                         int n_gates, int n_rows_max, int n_out, const int* x,
                         int* out, int n_in, int w, int threads, void* stream) {
  if (bad_program(pop, n_gates, n_rows_max, n_out, n_in, w, threads) ||
      pop > 65535) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(n_gates, n_rows_max, n_out, threads);
  cudaError_t err = prepare(eval_program_kernel, smem);
  if (err != cudaSuccess) return err;
  const Program prog{gates, n_live, rows, n_rows, taps,
                     pop, n_gates, n_rows_max, n_out};
  const dim3 grid((w + threads - 1) / threads, pop);
  eval_program_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      prog, reinterpret_cast<const uint32_t*>(x),
      reinterpret_cast<uint32_t*>(out), n_in, w);
  return cudaGetLastError();
}

int circuit_eval_program_spans(const int* gates, const int* n_live,
                               const int* rows, const int* n_rows,
                               const int* taps, int pop, int n_gates,
                               int n_rows_max, int n_out, const int* x,
                               const int* slots, const int* word_off,
                               const int* in_width, const int* live, int* out,
                               int n_launch, int n_in, int w_total, int span,
                               int threads, void* stream) {
  if (bad_program(pop, n_gates, n_rows_max, n_out, n_in, span, threads) ||
      n_launch < 1 || n_launch > 65535 || span > w_total) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(n_gates, n_rows_max, n_out, threads);
  cudaError_t err = prepare(eval_program_spans_kernel, smem);
  if (err != cudaSuccess) return err;
  const Program prog{gates, n_live, rows, n_rows, taps,
                     pop, n_gates, n_rows_max, n_out};
  const dim3 grid((span + threads - 1) / threads, n_launch);
  eval_program_spans_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      prog, reinterpret_cast<const uint32_t*>(x), slots, word_off, in_width,
      live, reinterpret_cast<uint32_t*>(out), n_in, w_total, span);
  return cudaGetLastError();
}

const char* circuit_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
