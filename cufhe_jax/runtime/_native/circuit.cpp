// cufhe_jax native runtime: encrypted-circuit graph builder + level scheduler.
//
// The reference library has no graph or scheduler: callers drive one CUDA
// stream per in-flight gate and poll StreamQuery (test_intensive.cc:21-54 in
// /root/reference is the canonical software scheduler written *around* the
// library). On an accelerator the profitable execution unit is a large batched gate
// program, so this component does what the reference leaves to callers,
// natively: it builds a Boolean-circuit DAG, eliminates dead gates,
// ASAP-levelizes it, and groups each level's gates by opcode so the Python
// executor can run every group as ONE fused batched XLA call.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

struct Gate {
    int32_t op;        // opcode (opaque to the scheduler except arity)
    int32_t nargs;     // 0 for inputs/constants
    int32_t args[3];   // wire ids
    int32_t level;     // assigned by compile(); -1 = dead
};

struct Builder {
    std::vector<Gate> wires;          // wire id == index
    std::vector<int32_t> outputs;
    std::vector<int32_t> inputs;      // wire ids of circuit inputs
    // schedule: level -> op -> flat [out, a, b, c] quadruples
    std::vector<std::map<int32_t, std::vector<int32_t>>> schedule;
    int32_t num_levels = 0;
    bool compiled = false;
    bool optimize = true;             // NOT/COPY absorption pass (sticky)
};

// Opcode contract for the optimizer (mirrors graph.py OPCODES order, which
// tests assert): 0 and, 1 andyn, 2 andny, 3 or, 4 oryn, 5 orny, 6 nand,
// 7 nor, 8 xor, 9 xnor, 10 mux, 11 nmux, 12 not, 13 copy.
constexpr int32_t kMux = 10, kNMux = 11, kNot = 12, kCopy = 13;

// kNegVar[op][i] = the gate computing op with input i negated. TFHE NOT is
// ciphertext negation, and each variant's linear-combination constants
// (golden.GATE_CONSTANTS) differ exactly by that sign: the rewrite is
// ciphertext-bit-exact for the eight +-1-coefficient gates, and decode-
// equivalent with an identical noise bound for xor/xnor (whose +-2
// coefficients leave a 4*noise pre-rotation difference; 4*mu wraps to 0).
// Reference gate table: bootstrap_gpu.cu:424-512.
constexpr int32_t kNegVar[10][2] = {
    {2, 1},  // and   -> andny, andyn
    {7, 0},  // andyn -> nor,   and
    {0, 7},  // andny -> and,   nor
    {5, 4},  // or    -> orny,  oryn
    {6, 3},  // oryn  -> nand,  or
    {3, 6},  // orny  -> or,    nand
    {4, 5},  // nand  -> oryn,  orny
    {1, 2},  // nor   -> andyn, andny
    {9, 9},  // xor   -> xnor
    {8, 8},  // xnor  -> xor
};

// Absorb NOT/COPY chains before levelization. Every wire canonicalizes to
// (root, parity): COPY aliases its source, NOT flips parity. Parity on a
// two-input gate operand folds into the gate's negated-input variant
// (bit-exact, see kNegVar); parity on a mux/nmux selector swaps the data
// operands; parity on a mux data operand (or a circuit output) keeps one
// canonical NOT wire per root — NOT chains and duplicate NOTs still dedup.
// The rewrite is idempotent (after it, every consumed operand has parity
// 0), so repeated cb_compile calls are safe; dead NOT/COPY wires are
// removed by the liveness pass in cb_compile.
void optimize_pass(Builder* b) {
    const int32_t n = static_cast<int32_t>(b->wires.size());
    std::vector<int32_t> root(n), par(n), not_of(n, -1);
    for (int32_t w = 0; w < n; ++w) {
        Gate& g = b->wires[w];
        if (g.op == kCopy && g.nargs == 1) {
            root[w] = root[g.args[0]];
            par[w] = par[g.args[0]];
        } else if (g.op == kNot && g.nargs == 1) {
            const int32_t a = g.args[0];
            root[w] = root[a];
            par[w] = par[a] ^ 1;
            if (par[w] == 1) {
                g.args[0] = root[a];  // canonical NOT reads the root
                if (not_of[root[w]] < 0) not_of[root[w]] = w;
            }
        } else {
            root[w] = w;
            par[w] = 0;
            if (g.nargs == 2 && g.op >= 0 && g.op <= 9) {
                for (int i = 0; i < 2; ++i) {
                    const int32_t a = g.args[i];
                    if (par[a]) g.op = kNegVar[g.op][i];
                    g.args[i] = root[a];
                }
            } else if (g.nargs == 3 && (g.op == kMux || g.op == kNMux)) {
                const int32_t c = g.args[0];
                if (par[c]) std::swap(g.args[1], g.args[2]);
                g.args[0] = root[c];
                for (int i = 1; i < 3; ++i) {
                    const int32_t a = g.args[i];
                    g.args[i] = par[a] ? not_of[root[a]] : root[a];
                }
            }
        }
    }
    for (int32_t& o : b->outputs)
        o = par[o] ? not_of[root[o]] : root[o];
}

}  // namespace

extern "C" {

Builder* cb_new() { return new Builder(); }

void cb_free(Builder* b) { delete b; }

int32_t cb_input(Builder* b) {
    b->wires.push_back(Gate{-1, 0, {0, 0, 0}, 0});
    int32_t id = static_cast<int32_t>(b->wires.size()) - 1;
    b->inputs.push_back(id);
    return id;
}

// A constant (trivial-ciphertext) wire; `value` is carried in args[0].
int32_t cb_const(Builder* b, int32_t value) {
    b->wires.push_back(Gate{-2, 0, {value, 0, 0}, 0});
    return static_cast<int32_t>(b->wires.size()) - 1;
}

// Returns the new wire id, or -1 on invalid argument wires.
int32_t cb_gate(Builder* b, int32_t op, int32_t nargs, const int32_t* args) {
    if (op < 0 || nargs < 1 || nargs > 3) return -1;
    Gate g{op, nargs, {0, 0, 0}, -1};
    int32_t n = static_cast<int32_t>(b->wires.size());
    for (int32_t i = 0; i < nargs; ++i) {
        if (args[i] < 0 || args[i] >= n) return -1;
        g.args[i] = args[i];
    }
    b->wires.push_back(g);
    b->compiled = false;
    return n;
}

int32_t cb_output(Builder* b, int32_t wire) {
    if (wire < 0 || wire >= static_cast<int32_t>(b->wires.size())) return -1;
    b->outputs.push_back(wire);
    b->compiled = false;
    return 0;
}

// Enable/disable the NOT/COPY absorption pass (default on). The pass
// rewrites wires in place at compile, so disabling only affects compiles
// that happen before the first optimized one.
void cb_set_optimize(Builder* b, int32_t on) { b->optimize = (on != 0); }

// Optimize (NOT/COPY absorption), dead-code-eliminate, ASAP-levelize,
// group by (level, op). Returns the number of levels (gates are never
// cyclic by construction: cb_gate only accepts already-existing wires).
int32_t cb_compile(Builder* b) {
    if (b->optimize) optimize_pass(b);
    const int32_t n = static_cast<int32_t>(b->wires.size());
    // 1. liveness from outputs
    std::vector<uint8_t> live(n, 0);
    std::vector<int32_t> stack(b->outputs);
    while (!stack.empty()) {
        int32_t w = stack.back();
        stack.pop_back();
        if (live[w]) continue;
        live[w] = 1;
        const Gate& g = b->wires[w];
        for (int32_t i = 0; i < g.nargs; ++i) stack.push_back(g.args[i]);
    }
    // 2. ASAP levels (wire ids are topologically ordered by construction)
    int32_t max_level = 0;
    for (int32_t w = 0; w < n; ++w) {
        Gate& g = b->wires[w];
        if (!live[w]) { g.level = -1; continue; }
        if (g.nargs == 0) { g.level = 0; continue; }
        int32_t lvl = 0;
        for (int32_t i = 0; i < g.nargs; ++i) {
            int32_t al = b->wires[g.args[i]].level;
            if (al < 0) al = 0;  // defensive; live gate args are live
            if (al > lvl) lvl = al;
        }
        g.level = lvl + 1;
        if (g.level > max_level) max_level = g.level;
    }
    // 3. group
    b->schedule.assign(max_level + 1, {});
    for (int32_t w = 0; w < n; ++w) {
        const Gate& g = b->wires[w];
        if (g.level <= 0 || g.nargs == 0) continue;
        std::vector<int32_t>& v = b->schedule[g.level][g.op];
        v.push_back(w);
        v.push_back(g.args[0]);
        v.push_back(g.nargs > 1 ? g.args[1] : -1);
        v.push_back(g.nargs > 2 ? g.args[2] : -1);
    }
    b->num_levels = max_level + 1;
    b->compiled = true;
    return b->num_levels;
}

int32_t cb_num_wires(const Builder* b) {
    return static_cast<int32_t>(b->wires.size());
}

int32_t cb_num_levels(const Builder* b) {
    return b->compiled ? b->num_levels : -1;
}

// Number of distinct opcodes scheduled in `level`.
int32_t cb_level_num_ops(const Builder* b, int32_t level) {
    if (!b->compiled || level < 0 || level >= b->num_levels) return -1;
    return static_cast<int32_t>(b->schedule[level].size());
}

// The idx-th opcode in `level` and its gate count; returns the opcode or -1.
int32_t cb_level_op(const Builder* b, int32_t level, int32_t idx,
                    int32_t* count) {
    if (!b->compiled || level < 0 || level >= b->num_levels) return -1;
    int32_t i = 0;
    for (const auto& kv : b->schedule[level]) {
        if (i++ == idx) {
            *count = static_cast<int32_t>(kv.second.size() / 4);
            return kv.first;
        }
    }
    return -1;
}

// Copy the flat [out, a, b, c] quadruples for (level, op) into `dst`.
int32_t cb_level_gates(const Builder* b, int32_t level, int32_t op,
                       int32_t* dst) {
    if (!b->compiled || level < 0 || level >= b->num_levels) return -1;
    auto it = b->schedule[level].find(op);
    if (it == b->schedule[level].end()) return -1;
    std::memcpy(dst, it->second.data(), it->second.size() * sizeof(int32_t));
    return static_cast<int32_t>(it->second.size() / 4);
}

int32_t cb_num_outputs(const Builder* b) {
    return static_cast<int32_t>(b->outputs.size());
}

void cb_outputs(const Builder* b, int32_t* dst) {
    std::memcpy(dst, b->outputs.data(), b->outputs.size() * sizeof(int32_t));
}

int32_t cb_num_inputs(const Builder* b) {
    return static_cast<int32_t>(b->inputs.size());
}

void cb_inputs(const Builder* b, int32_t* dst) {
    std::memcpy(dst, b->inputs.data(), b->inputs.size() * sizeof(int32_t));
}

// Constant value of a const wire (or -1 if not a const).
int32_t cb_const_value(const Builder* b, int32_t wire) {
    if (wire < 0 || wire >= static_cast<int32_t>(b->wires.size())) return -1;
    const Gate& g = b->wires[wire];
    return g.op == -2 ? g.args[0] : -1;
}

// Liveness of a wire after compile (dead gates are skipped by the executor).
int32_t cb_wire_level(const Builder* b, int32_t wire) {
    if (!b->compiled || wire < 0 ||
        wire >= static_cast<int32_t>(b->wires.size()))
        return -2;
    return b->wires[wire].level;
}

}  // extern "C"
