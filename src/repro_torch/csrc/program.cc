// Live-gate programs on the host: the native route of kernels/program.py.
//
// `program_compile` does what `_compile_numpy` does, for a whole population
// in one call, and writes the result straight into one int32 buffer laid
// out as
//
//   gates [P][L][3] | n_live [P] | rows [P][R] | n_rows [P] | taps [P][O]
//
// at the population's largest live-gate count L and staged-row count R, so
// the search can send the used prefix to the card in one copy.  Plain host
// C++ with a C interface; no static state: the caller passes the scratch,
// so several threads may compile at once.
#include <cstdint>
#include <cstring>

namespace {

// core/gates.py's NOT_A (the first 1-operand gate) and N_OPCODES (program.py's
// ZERO_GATE); exported below, and checked against gates.py when the library loads
constexpr int32_t kNotA = 6;
constexpr int32_t kZeroGate = 8;

enum : int32_t {
  kOk = 0,
  kBadFnIndex = -1,     // a gate_fn entry outside the fn-set table
  kBufferTooSmall = -2,
  kScratchTooSmall = -3,
};

struct Genomes {
  const int32_t* gate_fn;   // [P][n] opcodes, or fn-set indices with a table
  const int32_t* edge_src;  // [P][n][2]
  const int32_t* out_src;   // [P][O]
  const int32_t* table;     // [n_fn] or nullptr
  int32_t n_fn, n, n_out, n_in;
  int64_t total;            // I + n

  // the reference's vals[id]: a negative id wraps once, then it is clamped
  int64_t land(int64_t id) const {
    if (id < 0) id += total;
    return id < 0 ? 0 : (id >= total ? total - 1 : id);
  }
  // the gate's opcode; anything outside the gate table is the zero gate
  int32_t op(int64_t p, int64_t i) const {
    int64_t v = gate_fn[p * n + i];
    if (table != nullptr) {
      if (v < 0) v += n_fn;  // as an index into a tensor reads it
      v = table[v];
    }
    return (v >= 0 && v < kZeroGate) ? static_cast<int32_t>(v) : kZeroGate;
  }
  // operand k of gate i as a landed id, or -1 where it reads zero: past the
  // gate's arity, or at a row not written yet (I + i or later)
  int64_t operand(int64_t p, int64_t i, int k, int32_t opcode) const {
    const int arity = opcode < kNotA ? 2 : (opcode < kZeroGate ? 1 : 0);
    if (k >= arity) return -1;
    const int64_t s = land(edge_src[(p * n + i) * 2 + k]);
    return s < n_in + i ? s : -1;
  }
};

}  // namespace

extern "C" {

extern const int32_t program_not_a = kNotA;
extern const int32_t program_zero_gate = kZeroGate;

// int32 words of scratch that `program_compile` needs for these sizes
int64_t program_scratch_words(int32_t pop, int32_t n, int32_t n_in) {
  return static_cast<int64_t>(pop) * (n + n_in + 2) + n_in + n + 1 + n;
}

// Compile P genomes.  `table` (n_fn entries) maps gate_fn's fn-set indices
// to opcodes; nullptr: gate_fn holds raw opcodes.  `compact` 0 keeps every
// gate.  Writes L and R to lr[0], lr[1] and the program into out[0, used),
// used = P * (3L + R + O + 2).  Returns 0, or a negative code before
// writing anything.
int32_t program_compile(const int32_t* gate_fn, const int32_t* edge_src,
                        const int32_t* out_src, const int32_t* table, int32_t n_fn,
                        int32_t pop, int32_t n, int32_t n_out, int32_t n_in,
                        int32_t compact, int32_t* out, int64_t out_words,
                        int32_t* scratch, int64_t scratch_words, int32_t* lr) {
  if (scratch_words < program_scratch_words(pop, n, n_in)) return kScratchTooSmall;
  const Genomes g{gate_fn, edge_src, out_src, table, n_fn, n, n_out, n_in,
                  static_cast<int64_t>(n_in) + n};
  if (table != nullptr) {
    for (int64_t k = 0; k < static_cast<int64_t>(pop) * n; ++k) {
      if (gate_fn[k] < -n_fn || gate_fn[k] >= n_fn) return kBadFnIndex;
    }
  }
  int32_t* ids = scratch;                                  // [P][n] live gates, ascending
  int32_t* rds = ids + static_cast<int64_t>(pop) * n;      // [P][I] rows read, ascending
  int32_t* n_l = rds + static_cast<int64_t>(pop) * n_in;   // [P]
  int32_t* n_r = n_l + pop;                                // [P]
  int32_t* mark = n_r + pop;                               // [I + n + 1] by landed id
  int32_t* stack = mark + g.total + 1;                     // [n]

  // pass 1: each circuit's live gates (reached back from its taps) and the
  // input rows they and the taps read
  int32_t big_l = 0, big_r = 0;
  for (int64_t p = 0; p < pop; ++p) {
    std::memset(mark, 0, sizeof(int32_t) * (g.total + 1));
    if (compact) {
      int64_t top = 0;
      for (int o = 0; o < n_out; ++o) {
        const int64_t t = g.land(out_src[p * n_out + o]);
        if (t >= n_in && !mark[t]) { mark[t] = 1; stack[top++] = static_cast<int32_t>(t - n_in); }
      }
      while (top > 0) {
        const int64_t i = stack[--top];
        const int32_t opcode = g.op(p, i);
        for (int k = 0; k < 2; ++k) {
          const int64_t s = g.operand(p, i, k, opcode);
          if (s >= n_in && !mark[s]) { mark[s] = 1; stack[top++] = static_cast<int32_t>(s - n_in); }
        }
      }
    } else {
      for (int64_t i = 0; i < n; ++i) mark[n_in + i] = 1;
    }
    int32_t* id = ids + p * n;
    int32_t nl = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (!mark[n_in + i]) continue;
      id[nl++] = static_cast<int32_t>(i);
      const int32_t opcode = g.op(p, i);
      for (int k = 0; k < 2; ++k) {
        const int64_t s = g.operand(p, i, k, opcode);
        if (s >= 0 && s < n_in) mark[s] = 1;
      }
    }
    for (int o = 0; o < n_out; ++o) {
      const int64_t t = g.land(out_src[p * n_out + o]);
      if (t < n_in) mark[t] = 1;
    }
    int32_t* rd = rds + p * n_in;
    int32_t nr = 0;
    for (int32_t r = 0; r < n_in; ++r) {
      if (mark[r]) rd[nr++] = r;
    }
    n_l[p] = nl;
    n_r[p] = nr;
    if (nl > big_l) big_l = nl;
    if (nr > big_r) big_r = nr;
  }

  const int64_t used = static_cast<int64_t>(pop) * (3LL * big_l + big_r + n_out + 2);
  if (out_words < used) return kBufferTooSmall;
  int32_t* o_gates = out;
  int32_t* o_live = o_gates + static_cast<int64_t>(pop) * big_l * 3;
  int32_t* o_rows = o_live + pop;
  int32_t* o_nrows = o_rows + static_cast<int64_t>(pop) * big_r;
  int32_t* o_taps = o_nrows + pop;
  const int32_t zero = big_r + big_l;
  int32_t* code = mark;  // landed id -> code, for the ids a live gate or tap reads

  // pass 2: codes [0, R) for rows, [R, R + L) for gates, R + L for zero
  for (int64_t p = 0; p < pop; ++p) {
    const int32_t* id = ids + p * n;
    const int32_t* rd = rds + p * n_in;
    const int32_t nl = n_l[p], nr = n_r[p];
    for (int32_t j = 0; j < nr; ++j) code[rd[j]] = j;
    for (int32_t j = 0; j < nl; ++j) code[n_in + id[j]] = big_r + j;
    int32_t* gp = o_gates + p * big_l * 3;
    for (int32_t j = 0; j < nl; ++j) {
      const int32_t opcode = g.op(p, id[j]);
      gp[3 * j] = opcode;
      for (int k = 0; k < 2; ++k) {
        const int64_t s = g.operand(p, id[j], k, opcode);
        gp[3 * j + 1 + k] = s < 0 ? zero : code[s];
      }
    }
    for (int32_t j = nl; j < big_l; ++j) {
      gp[3 * j] = kZeroGate;
      gp[3 * j + 1] = zero;
      gp[3 * j + 2] = zero;
    }
    o_live[p] = nl;
    int32_t* rp = o_rows + p * big_r;
    for (int32_t j = 0; j < nr; ++j) rp[j] = rd[j];
    for (int32_t j = nr; j < big_r; ++j) rp[j] = 0;
    o_nrows[p] = nr;
    for (int o = 0; o < n_out; ++o) {
      o_taps[p * n_out + o] = code[g.land(out_src[p * n_out + o])];
    }
  }
  lr[0] = big_l;
  lr[1] = big_r;
  return kOk;
}

}  // extern "C"
