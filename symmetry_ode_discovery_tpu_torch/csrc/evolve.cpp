// Genetic-programming breeding core: tournament selection, postfix-subtree
// crossover, point/hoist/subtree mutation over fixed-length tape populations.
//
// The port's own copy of symmetry_ode_discovery_tpu/symgp/native/evolve.cpp,
// kept byte for byte in its code so that both packages breed the same
// populations from the same seeds. Host code: fitness evaluation runs on the
// card (csrc/tape_eval.cu); this core only rewrites int32/float32 tape
// arrays.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 (no -march=native, so the library
// loads on any x86-64 host), by symgp/evolve.py through ops/_nvcc.py into
// build/torch_kernels/; bound with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr int PAD = 0, CONST = 1, VAR = 2;
constexpr int ARITY[11] = {0, 0, 0, 2, 2, 2, 2, 1, 1, 1, 1};

struct Tape {
  std::vector<int32_t> ops, args;
  std::vector<float> consts;
};

int tape_len(const int32_t* ops, int L) {
  int n = 0;
  for (int i = 0; i < L; ++i)
    if (ops[i] != PAD) n = i + 1;
  return n;
}

int subtree_start(const int32_t* ops, int i) {
  int need = 1, j = i;
  while (need > 0 && j >= 0) {
    need -= 1;
    need += ARITY[ops[j]];
    --j;
  }
  return j + 1;
}

// Random postfix program of ~target_len slots (mirrors tape.py random_tape).
Tape random_tape(std::mt19937_64& rng, int L, int n_vars, const int32_t* bins,
                 int n_bins, const int32_t* uns, int n_uns, float const_range,
                 int target_len) {
  // mirror tape.py random_tape: a target beyond the tape capacity would
  // grow a valid program longer than L that resize(L) then truncates into
  // a malformed postfix prefix
  if (target_len > L) target_len = L;
  std::uniform_real_distribution<float> unif(0.f, 1.f);
  std::uniform_real_distribution<float> crange(-const_range, const_range);
  Tape t;
  int depth = 0;
  while ((int)t.ops.size() < target_len) {
    int remaining = target_len - (int)t.ops.size();
    std::vector<int> choices;
    if (depth >= 1 && n_uns > 0)
      for (int k = 0; k < n_uns; ++k) choices.push_back(uns[k]);
    if (depth >= 2)
      for (int k = 0; k < n_bins; ++k) {
        choices.push_back(bins[k]);
        choices.push_back(bins[k]);
      }
    if (depth < remaining) {
      choices.push_back(CONST);
      choices.push_back(VAR);
      choices.push_back(VAR);
    }
    if (choices.empty()) break;
    int op = choices[rng() % choices.size()];
    t.ops.push_back(op);
    if (op == VAR) {
      t.args.push_back((int32_t)(rng() % n_vars));
      t.consts.push_back(0.f);
      ++depth;
    } else if (op == CONST) {
      t.args.push_back(0);
      t.consts.push_back(crange(rng));
      ++depth;
    } else {
      t.args.push_back(0);
      t.consts.push_back(0.f);
      depth -= ARITY[op] - 1;
    }
    if (depth == 1 && unif(rng) < 0.3f) break;
  }
  while (depth > 1 && (int)t.ops.size() < L) {
    t.ops.push_back(bins[rng() % n_bins]);
    t.args.push_back(0);
    t.consts.push_back(0.f);
    --depth;
  }
  if (depth != 1) {
    t.ops = {VAR};
    t.args = {(int32_t)(rng() % n_vars)};
    t.consts = {0.f};
  }
  t.ops.resize(L, PAD);
  t.args.resize(L, 0);
  t.consts.resize(L, 0.f);
  return t;
}

Tape get_row(const int32_t* ops, const int32_t* args, const float* consts,
             int idx, int L) {
  Tape t;
  t.ops.assign(ops + (size_t)idx * L, ops + (size_t)(idx + 1) * L);
  t.args.assign(args + (size_t)idx * L, args + (size_t)(idx + 1) * L);
  t.consts.assign(consts + (size_t)idx * L, consts + (size_t)(idx + 1) * L);
  return t;
}

Tape splice(const Tape& a, const Tape& b, std::mt19937_64& rng, int L) {
  int la = tape_len(a.ops.data(), L), lb = tape_len(b.ops.data(), L);
  if (la == 0 || lb == 0) return a;
  int ia = (int)(rng() % la), ib = (int)(rng() % lb);
  int sa = subtree_start(a.ops.data(), ia), sb = subtree_start(b.ops.data(), ib);
  int new_len = sa + (ib - sb + 1) + (la - ia - 1);
  if (new_len > L) return a;
  Tape out;
  auto app = [&](const Tape& src, int from, int to) {
    for (int i = from; i < to; ++i) {
      out.ops.push_back(src.ops[i]);
      out.args.push_back(src.args[i]);
      out.consts.push_back(src.consts[i]);
    }
  };
  app(a, 0, sa);
  app(b, sb, ib + 1);
  app(a, ia + 1, la);
  out.ops.resize(L, PAD);
  out.args.resize(L, 0);
  out.consts.resize(L, 0.f);
  return out;
}

Tape mutate(const Tape& ind, std::mt19937_64& rng, int L, int n_vars,
            const int32_t* bins, int n_bins, const int32_t* uns, int n_uns,
            float const_range) {
  std::uniform_real_distribution<float> unif(0.f, 1.f);
  std::normal_distribution<float> normal(0.f, 1.f);
  Tape t = ind;
  int len = tape_len(t.ops.data(), L);
  if (len == 0)
    return random_tape(rng, L, n_vars, bins, n_bins, uns, n_uns, const_range,
                       1 + (int)(rng() % 9));
  float r = unif(rng);
  if (r < 0.4f) {  // point mutation
    int i = (int)(rng() % len);
    int op = t.ops[i];
    if (op == VAR) {
      t.args[i] = (int32_t)(rng() % n_vars);
    } else if (op == CONST) {
      t.consts[i] = t.consts[i] * (1.f + 0.3f * normal(rng)) + 0.1f * normal(rng);
    } else if (ARITY[op] == 2) {
      t.ops[i] = bins[rng() % n_bins];
    } else if (ARITY[op] == 1 && n_uns > 0) {
      t.ops[i] = uns[rng() % n_uns];
    }
  } else if (r < 0.55f && len > 1) {  // hoist
    int i = (int)(rng() % len);
    int s = subtree_start(t.ops.data(), i);
    Tape out;
    for (int k = s; k <= i; ++k) {
      out.ops.push_back(t.ops[k]);
      out.args.push_back(t.args[k]);
      out.consts.push_back(t.consts[k]);
    }
    out.ops.resize(L, PAD);
    out.args.resize(L, 0);
    out.consts.resize(L, 0.f);
    return out;
  } else if (r < 0.8f) {  // subtree replacement
    int i = (int)(rng() % len);
    int s = subtree_start(t.ops.data(), i);
    Tape sub = random_tape(rng, L, n_vars, bins, n_bins, uns, n_uns,
                           const_range, 1 + (int)(rng() % 7));
    int nlen = tape_len(sub.ops.data(), L);
    int total = s + nlen + (len - i - 1);
    if (total <= L) {
      Tape out;
      auto app = [&](const Tape& src, int from, int to) {
        for (int k = from; k < to; ++k) {
          out.ops.push_back(src.ops[k]);
          out.args.push_back(src.args[k]);
          out.consts.push_back(src.consts[k]);
        }
      };
      app(t, 0, s);
      app(sub, 0, nlen);
      app(t, i + 1, len);
      out.ops.resize(L, PAD);
      out.args.resize(L, 0);
      out.consts.resize(L, 0.f);
      return out;
    }
  } else {  // fresh individual
    return random_tape(rng, L, n_vars, bins, n_bins, uns, n_uns, const_range,
                       1 + (int)(rng() % 9));
  }
  return t;
}

}  // namespace

// Grouped variant: rows come in groups of `stride` (multi-component systems,
// e.g. the two-equation trees of the reference's symmreg objective,
// main_pysr.py:88-99). Selection happens at group level on `fitness`
// (n_groups entries); crossover partners are whole groups; variation applies
// per component row.
extern "C" void breed_grouped(
    const int32_t* ops, const int32_t* args, const float* consts,
    const float* fitness, int32_t* out_ops, int32_t* out_args,
    float* out_consts, int n_groups, int stride, int L, int tournament_size,
    int elitism, float p_crossover, float p_mutate, int n_vars,
    const int32_t* bins, int n_bins, const int32_t* uns, int n_uns,
    float const_range, unsigned long long seed) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> unif(0.f, 1.f);

  std::vector<int> order(n_groups);
  for (int i = 0; i < n_groups; ++i) order[i] = i;
  std::partial_sort(order.begin(),
                    order.begin() + std::min(elitism, n_groups), order.end(),
                    [&](int a, int b) { return fitness[a] < fitness[b]; });

  auto tournament = [&]() {
    int best = (int)(rng() % n_groups);
    for (int k = 1; k < tournament_size; ++k) {
      int c = (int)(rng() % n_groups);
      if (fitness[c] < fitness[best]) best = c;
    }
    return best;
  };

  for (int o = 0; o < n_groups; ++o) {
    int a, b = -1;
    bool do_cx = false, do_mut = false;
    if (o < elitism) {
      a = order[o];
    } else {
      a = tournament();
      do_cx = unif(rng) < p_crossover;
      if (do_cx) b = tournament();
      do_mut = unif(rng) < p_mutate;
    }
    for (int c = 0; c < stride; ++c) {
      int row = a * stride + c;
      Tape child = get_row(ops, args, consts, row, L);
      if (do_cx)
        child = splice(child, get_row(ops, args, consts, b * stride + c, L),
                       rng, L);
      if (do_mut)
        child = mutate(child, rng, L, n_vars, bins, n_bins, uns, n_uns,
                       const_range);
      int out_row = o * stride + c;
      std::memcpy(out_ops + (size_t)out_row * L, child.ops.data(),
                  L * sizeof(int32_t));
      std::memcpy(out_args + (size_t)out_row * L, child.args.data(),
                  L * sizeof(int32_t));
      std::memcpy(out_consts + (size_t)out_row * L, child.consts.data(),
                  L * sizeof(float));
    }
  }
}

extern "C" void breed(
    const int32_t* ops, const int32_t* args, const float* consts,
    const float* fitness, int32_t* out_ops, int32_t* out_args,
    float* out_consts, int P, int L, int tournament_size, int elitism,
    float p_crossover, float p_mutate, int n_vars, const int32_t* bins,
    int n_bins, const int32_t* uns, int n_uns, float const_range,
    unsigned long long seed) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> unif(0.f, 1.f);

  // elitism: copy the best `elitism` individuals
  std::vector<int> order(P);
  for (int i = 0; i < P; ++i) order[i] = i;
  std::partial_sort(order.begin(), order.begin() + std::min(elitism, P),
                    order.end(),
                    [&](int a, int b) { return fitness[a] < fitness[b]; });

  auto tournament = [&]() {
    int best = (int)(rng() % P);
    for (int k = 1; k < tournament_size; ++k) {
      int c = (int)(rng() % P);
      if (fitness[c] < fitness[best]) best = c;
    }
    return best;
  };

  for (int o = 0; o < P; ++o) {
    Tape child;
    if (o < elitism) {
      child = get_row(ops, args, consts, order[o], L);
    } else {
      int a = tournament();
      child = get_row(ops, args, consts, a, L);
      if (unif(rng) < p_crossover) {
        int b = tournament();
        child = splice(child, get_row(ops, args, consts, b, L), rng, L);
      }
      if (unif(rng) < p_mutate) {
        child = mutate(child, rng, L, n_vars, bins, n_bins, uns, n_uns,
                       const_range);
      }
    }
    std::memcpy(out_ops + (size_t)o * L, child.ops.data(), L * sizeof(int32_t));
    std::memcpy(out_args + (size_t)o * L, child.args.data(), L * sizeof(int32_t));
    std::memcpy(out_consts + (size_t)o * L, child.consts.data(), L * sizeof(float));
  }
}
