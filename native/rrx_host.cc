// rrx_host — native host runtime for roaringregex.
//
// The reference implements its whole compiler in C++ (Parser.cpp: stack
// machine; NFA.cc: epsilon-eliminating combinators). This library is the
// framework's native equivalent of those host-side components:
//
//  * POSIX-ERE parser -> Glushkov position NFA (the graph-builder): emits
//    the logical NFA (follow edges, position labels, accept set) through a
//    C ABI; Python (compiler/native.py) binds it with ctypes and builds
//    identical DeviceProgram tables. Semantics mirror compiler/parser.py +
//    compiler/nfa.py exactly (position numbering, repeat expansion,
//    anchors as BOS/EOS virtual symbols) — parity is enforced by
//    tests/test_native.py over the conformance corpus and fuzzing.
//
//  * newline-record corpus packer (the data-loader): splits a raw byte
//    buffer into records and packs them into the padded [B, L] uint8 +
//    lengths layout the device engines consume, without a Python loop.
//
// Build: make -C native  (g++ -O3 -shared; no external dependencies).
#include <cstdint>
#include <cstring>
#include <memory>
#include <set>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kBOS = 128;
constexpr int kEOS = 129;
constexpr int kNSYM = 130;
constexpr int kMaxStates = 16384;  // mirrors compiler/nfa.py MAX_STATES

// ---------------------------------------------------------------------------
// AST (mirrors compiler/parser.py node shapes)
// ---------------------------------------------------------------------------

struct Node;
using NodePtr = std::unique_ptr<Node>;

enum class Kind { Empty, Lit, Concat, Alt, Repeat };

struct Node {
  Kind kind;
  // Lit
  std::vector<uint8_t> syms;  // bitmask over kNSYM bits, 17 bytes
  // Concat / Alt
  std::vector<NodePtr> parts;
  // Repeat
  NodePtr child;
  long lo = 0;
  long hi = -1;  // -1 = unbounded
};

NodePtr mk(Kind k) {
  auto n = std::make_unique<Node>();
  n->kind = k;
  return n;
}

NodePtr mk_lit(const std::vector<uint8_t>& mask) {
  auto n = mk(Kind::Lit);
  n->syms = mask;
  return n;
}

std::vector<uint8_t> empty_mask() {
  return std::vector<uint8_t>((kNSYM + 7) / 8, 0);
}

void mask_add(std::vector<uint8_t>& m, int c) { m[c / 8] |= 1 << (c % 8); }
bool mask_has(const std::vector<uint8_t>& m, int c) {
  return m[c / 8] & (1 << (c % 8));
}
bool mask_empty(const std::vector<uint8_t>& m) {
  for (uint8_t b : m)
    if (b) return false;
  return true;
}

// ---------------------------------------------------------------------------
// Parser (recursive descent; mirrors _Parser in compiler/parser.py)
// ---------------------------------------------------------------------------

struct SyntaxError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

class Parser {
 public:
  explicit Parser(const std::string& pat) : pat_(pat) {}

  NodePtr parse() {
    NodePtr n = alternation();
    if (pos_ != pat_.size())
      throw SyntaxError("unexpected '" + std::string(1, pat_[pos_]) +
                        "' at position " + std::to_string(pos_));
    return n;
  }

 private:
  const std::string& pat_;
  size_t pos_ = 0;

  int peek() { return pos_ < pat_.size() ? (unsigned char)pat_[pos_] : -1; }
  int next() {
    if (pos_ >= pat_.size()) throw SyntaxError("unexpected end of pattern");
    return (unsigned char)pat_[pos_++];
  }
  void expect(char c) {
    if (peek() != c)
      throw SyntaxError("expected '" + std::string(1, c) + "' at position " +
                        std::to_string(pos_));
    pos_++;
  }

  NodePtr alternation() {
    std::vector<NodePtr> parts;
    parts.push_back(concat());
    while (peek() == '|') {
      pos_++;
      parts.push_back(concat());
    }
    if (parts.size() > 1) {
      for (auto& p : parts)
        if (p->kind == Kind::Empty)
          throw SyntaxError("empty alternation branch");
      auto n = mk(Kind::Alt);
      n->parts = std::move(parts);
      return n;
    }
    return std::move(parts[0]);
  }

  NodePtr concat() {
    std::vector<NodePtr> parts;
    while (true) {
      int c = peek();
      if (c == -1 || c == '|' || c == ')') break;
      parts.push_back(repeat());
    }
    if (parts.empty()) return mk(Kind::Empty);
    if (parts.size() == 1) return std::move(parts[0]);
    auto n = mk(Kind::Concat);
    n->parts = std::move(parts);
    return n;
  }

  NodePtr repeat() {
    NodePtr node = atom();
    while (true) {
      int c = peek();
      long lo, hi;
      if (c == '*') {
        pos_++;
        lo = 0;
        hi = -1;
      } else if (c == '+') {
        pos_++;
        lo = 1;
        hi = -1;
      } else if (c == '?') {
        pos_++;
        lo = 0;
        hi = 1;
      } else if (c == '{') {
        braces(lo, hi);
      } else {
        return node;
      }
      if (node->kind == Kind::Empty) continue;  // quantified empty is empty
      auto r = mk(Kind::Repeat);
      r->child = std::move(node);
      r->lo = lo;
      r->hi = hi;
      node = std::move(r);
    }
  }

  void braces(long& lo, long& hi) {
    expect('{');
    lo = integer("repetition lower bound");
    if (peek() == ',') {
      pos_++;
      if (peek() == '}')
        hi = -1;
      else
        hi = integer("repetition upper bound");
    } else {
      hi = lo;
    }
    expect('}');
    if (hi >= 0 && hi < lo)
      throw SyntaxError("invalid repetition bounds {" + std::to_string(lo) +
                        "," + std::to_string(hi) + "}");
  }

  long integer(const char* what) {
    size_t start = pos_;
    while (peek() >= '0' && peek() <= '9') pos_++;
    if (pos_ == start)
      throw SyntaxError(std::string("expected ") + what + " at position " +
                        std::to_string(pos_));
    return std::stol(pat_.substr(start, pos_ - start));
  }

  int byte_of(int ch) {
    if (ch > 127) throw SyntaxError("non-ASCII character (ASCII-only)");
    return ch;
  }

  NodePtr atom() {
    int c = next();
    if (c == '(') {
      NodePtr n = alternation();
      expect(')');
      return n;
    }
    if (c == '[') return mk_lit(bracket());
    if (c == '.') {
      auto m = empty_mask();
      for (int b = 0; b < 128; b++) mask_add(m, b);
      return mk_lit(m);
    }
    if (c == '^') {
      auto m = empty_mask();
      mask_add(m, kBOS);
      return mk_lit(m);
    }
    if (c == '$') {
      auto m = empty_mask();
      mask_add(m, kEOS);
      return mk_lit(m);
    }
    if (c == '\\') {
      auto m = empty_mask();
      mask_add(m, byte_of(next()));
      return mk_lit(m);
    }
    if (c == '*' || c == '+' || c == '?' || c == '{')
      throw SyntaxError("quantifier with nothing to repeat");
    if (c == ')') throw SyntaxError("unbalanced ')'");
    auto m = empty_mask();
    mask_add(m, byte_of(c));
    return mk_lit(m);
  }

  std::vector<uint8_t> bracket() {
    auto members = empty_mask();
    bool negate = false;
    if (peek() == '^') {
      pos_++;
      negate = true;
    }
    while (true) {
      int c = peek();
      if (c == -1) throw SyntaxError("unterminated bracket expression");
      if (c == ']') {
        pos_++;
        break;
      }
      pos_++;
      if (c == '\\') {
        mask_add(members, byte_of(next()));
        continue;
      }
      // range?
      if (peek() == '-' && pos_ + 1 < pat_.size() &&
          pat_[pos_ + 1] != ']') {
        pos_++;  // consume '-'
        int hi_ch = next();
        if (hi_ch == '\\') hi_ch = next();
        int lo_b = byte_of(c), hi_b = byte_of(hi_ch);
        if (hi_b < lo_b) throw SyntaxError("reversed range");
        for (int b = lo_b; b <= hi_b; b++) mask_add(members, b);
      } else {
        mask_add(members, byte_of(c));
      }
    }
    if (negate) {
      auto m = empty_mask();
      for (int b = 0; b < 128; b++)
        if (!mask_has(members, b)) mask_add(m, b);
      members = m;
    }
    if (mask_empty(members)) throw SyntaxError("empty bracket expression");
    return members;
  }
};

// ---------------------------------------------------------------------------
// Glushkov builder (mirrors compiler/nfa.py _Builder; bitset position sets)
// ---------------------------------------------------------------------------

struct PosSet {
  std::vector<uint64_t> w;
  explicit PosSet(size_t nbits = 0) : w((nbits + 63) / 64, 0) {}
  void add(int p) { w[p >> 6] |= 1ull << (p & 63); }
  void operator|=(const PosSet& o) {
    for (size_t i = 0; i < w.size(); i++) w[i] |= o.w[i];
  }
  template <class F>
  void for_each(F f) const {
    for (size_t i = 0; i < w.size(); i++) {
      uint64_t x = w[i];
      while (x) {
        f(int(i * 64 + __builtin_ctzll(x)));
        x &= x - 1;
      }
    }
  }
};

struct G {
  bool nullable;
  PosSet first, last;
};

long count_positions(const Node* n) {
  switch (n->kind) {
    case Kind::Empty:
      return 0;
    case Kind::Lit:
      return 1;
    case Kind::Concat:
    case Kind::Alt: {
      long s = 0;
      for (auto& p : n->parts) s += count_positions(p.get());
      return s;
    }
    case Kind::Repeat: {
      long c = count_positions(n->child.get());
      if (n->hi < 0) return c * std::max(n->lo, 1l);
      if (n->hi == 0) return 0;
      return c * n->hi;
    }
  }
  return 0;
}

class Builder {
 public:
  explicit Builder(size_t n_pos)
      : n_pos_(n_pos), labels_(), follow_(n_pos, PosSet(n_pos + 1)) {
    labels_.reserve(n_pos);
  }

  size_t n_pos_;
  std::vector<std::vector<uint8_t>> labels_;    // per position (1-based - 1)
  std::vector<PosSet> follow_;                  // per position (1-based - 1)

  int new_pos(const std::vector<uint8_t>& syms) {
    labels_.push_back(syms);
    return (int)labels_.size();  // 1-based
  }

  G build(const Node* n) {
    switch (n->kind) {
      case Kind::Empty:
        return G{true, PosSet(n_pos_ + 1), PosSet(n_pos_ + 1)};
      case Kind::Lit: {
        int p = new_pos(n->syms);
        G g{false, PosSet(n_pos_ + 1), PosSet(n_pos_ + 1)};
        g.first.add(p);
        g.last.add(p);
        return g;
      }
      case Kind::Concat: {
        G g = build(n->parts[0].get());
        for (size_t i = 1; i < n->parts.size(); i++) {
          G h = build(n->parts[i].get());
          concat_into(g, h);
        }
        return g;
      }
      case Kind::Alt: {
        G g{false, PosSet(n_pos_ + 1), PosSet(n_pos_ + 1)};
        for (auto& p : n->parts) {
          G h = build(p.get());
          g.nullable = g.nullable || h.nullable;
          g.first |= h.first;
          g.last |= h.last;
        }
        return g;
      }
      case Kind::Repeat:
        return repeat(n);
    }
    throw std::logic_error("unreachable");
  }

 private:
  void link(const PosSet& lasts, const PosSet& firsts) {
    lasts.for_each([&](int p) { follow_[p - 1] |= firsts; });
  }

  void concat_into(G& g, G& h) {
    link(g.last, h.first);
    bool nullable = g.nullable && h.nullable;
    if (g.nullable) g.first |= h.first;
    PosSet last = h.last;
    if (h.nullable) last |= g.last;
    g.nullable = nullable;
    g.last = last;
  }

  G star(G g) {
    link(g.last, g.first);
    g.nullable = true;
    return g;
  }

  G plus(G g) {
    link(g.last, g.first);
    return g;
  }

  G repeat(const Node* n) {
    const Node* child = n->child.get();
    long lo = n->lo, hi = n->hi;
    if (hi == 0) return G{true, PosSet(n_pos_ + 1), PosSet(n_pos_ + 1)};
    if (hi < 0) {
      if (lo == 0) return star(build(child));
      std::vector<G> gs;
      for (long i = 0; i < lo; i++) gs.push_back(build(child));
      gs.back() = plus(std::move(gs.back()));
      return concat_all(std::move(gs));
    }
    std::vector<G> gs;
    for (long i = 0; i < lo; i++) gs.push_back(build(child));
    for (long i = 0; i < hi - lo; i++) {
      G g = build(child);
      g.nullable = true;  // optionalized copy
      gs.push_back(std::move(g));
    }
    return concat_all(std::move(gs));
  }

  G concat_all(std::vector<G> gs) {
    G g = std::move(gs[0]);
    for (size_t i = 1; i < gs.size(); i++) concat_into(g, gs[i]);
    return g;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

struct RrxProgram {
  long n_states;
  bool nullable;
  std::vector<int32_t> edges;    // flattened (i, j) pairs
  std::vector<uint8_t> labels;   // (S-1) * 17 symbol bitmasks
  std::vector<int32_t> accept;
};

extern "C" {

RrxProgram* rrx_compile(const char* pattern, char* err, int errlen) {
  try {
    std::string pat(pattern);
    Parser parser(pat);
    NodePtr ast = parser.parse();
    long n_pos = count_positions(ast.get());
    if (n_pos + 1 > kMaxStates)
      throw SyntaxError("pattern needs " + std::to_string(n_pos + 1) +
                        " states > MAX_STATES=" + std::to_string(kMaxStates));
    Builder b((size_t)n_pos);
    G g = b.build(ast.get());
    auto out = std::make_unique<RrxProgram>();
    out->n_states = n_pos + 1;
    out->nullable = g.nullable;
    // state 0's follow row = first(root); rows 1..n = builder follow sets
    g.first.for_each([&](int j) {
      out->edges.push_back(0);
      out->edges.push_back(j);
    });
    for (long i = 0; i < n_pos; i++) {
      b.follow_[i].for_each([&](int j) {
        out->edges.push_back((int32_t)(i + 1));
        out->edges.push_back(j);
      });
    }
    const size_t nbytes = (kNSYM + 7) / 8;
    out->labels.resize((size_t)n_pos * nbytes);
    for (long p = 0; p < n_pos; p++)
      std::memcpy(&out->labels[p * nbytes], b.labels_[p].data(), nbytes);
    std::set<int32_t> acc;
    g.last.for_each([&](int p) { acc.insert(p); });
    if (g.nullable) acc.insert(0);
    out->accept.assign(acc.begin(), acc.end());
    return out.release();
  } catch (const std::exception& e) {
    if (err && errlen > 0) {
      std::strncpy(err, e.what(), errlen - 1);
      err[errlen - 1] = 0;
    }
    return nullptr;
  }
}

long rrx_n_states(const RrxProgram* p) { return p->n_states; }
int rrx_nullable(const RrxProgram* p) { return p->nullable ? 1 : 0; }
long rrx_n_edges(const RrxProgram* p) { return (long)(p->edges.size() / 2); }
void rrx_edges(const RrxProgram* p, int32_t* out) {
  std::memcpy(out, p->edges.data(), p->edges.size() * sizeof(int32_t));
}
void rrx_labels(const RrxProgram* p, uint8_t* out) {
  std::memcpy(out, p->labels.data(), p->labels.size());
}
long rrx_n_accept(const RrxProgram* p) { return (long)p->accept.size(); }
void rrx_accept(const RrxProgram* p, int32_t* out) {
  std::memcpy(out, p->accept.data(), p->accept.size() * sizeof(int32_t));
}
void rrx_free(RrxProgram* p) { delete p; }

// ---------------------------------------------------------------------------
// Host scan engine: a self-contained CPU matcher over the compiled program
// (the capability the reference ships as librregex.a — its per-byte
// Processor::shift row-union hot loop, NFA.cc:72-102 — here with 32-bit
// state ids and working anchors). Used by the CLI / library when no device
// runtime is wanted; the device engine remains the production path.
// ---------------------------------------------------------------------------

// Lazily built subset DFA over uint64 bitsets (S <= 64): memoizes
// (subset, byte) -> subset so the steady-state scan is one table load per
// byte instead of a row-union — ~10-20x the reference's hot loop on the
// same single core. Capped; overflowing patterns fall back to the
// subset-stepping loop mid-scan.
struct LazyDfa {
  static constexpr int32_t kCap = 4096;
  std::unordered_map<uint64_t, int32_t> ids;
  std::vector<uint64_t> bits;   // id -> subset
  std::vector<int32_t> rows;    // [id][kNSYM] -> next id, -1 unbuilt
  std::vector<uint8_t> acc;     // id -> subset hits accept (excl. state 0)
  bool full = false;            // cap hit: skip the DFA path entirely

  int32_t intern(uint64_t d, uint64_t accept_mask) {
    auto it = ids.find(d);
    if (it != ids.end()) return it->second;
    if ((int32_t)bits.size() >= kCap) {
      full = true;
      return -2;  // caller re-runs the subset loop
    }
    int32_t id = (int32_t)bits.size();
    ids.emplace(d, id);
    bits.push_back(d);
    rows.insert(rows.end(), kNSYM, -1);
    acc.push_back((d & accept_mask & ~1ull) != 0);
    return id;
  }
};

// 128-bit variant for the 65..128-state tier (the reference's 128-bit
// SIMD BitSet<2> analog): same lazy subset-DFA idea keyed on
// unsigned __int128.
typedef unsigned __int128 u128;

struct LazyDfa128 {
  static constexpr int32_t kCap = 4096;
  struct H {
    size_t operator()(u128 v) const {
      uint64_t x = (uint64_t)v ^ ((uint64_t)(v >> 64) * 0x9e3779b97f4a7c15ull);
      x ^= x >> 33;
      x *= 0xff51afd7ed558ccdull;
      x ^= x >> 33;
      return (size_t)x;
    }
  };
  std::unordered_map<u128, int32_t, H> ids;
  std::vector<u128> bits;
  std::vector<int32_t> rows;
  std::vector<uint8_t> acc;
  bool full = false;

  int32_t intern(u128 d, u128 accept_mask) {
    auto it = ids.find(d);
    if (it != ids.end()) return it->second;
    if ((int32_t)bits.size() >= kCap) {
      full = true;
      return -2;
    }
    int32_t id = (int32_t)bits.size();
    ids.emplace(d, id);
    bits.push_back(d);
    rows.insert(rows.end(), kNSYM, -1);
    acc.push_back((d & accept_mask & ~(u128)1) != 0);
    return id;
  }
};

struct RrxScanner {
  long S;
  bool nullable;
  size_t words;                    // ceil(S / 64)
  std::vector<uint64_t> follow;    // [S][words] follow-row masks
  std::vector<uint64_t> bsym;      // [kNSYM][words] symbol-entry masks
  std::vector<uint64_t> accept;    // [words]
  std::vector<uint64_t> pred;      // [S][words] transposed follow (for the
                                   // backward start-viability pass)
  mutable LazyDfa dfa_seeded;      // T(D,c) = step(D | {0}, c)
  mutable LazyDfa dfa_plain;       // T(D,c) = step(D, c)
  mutable LazyDfa dfa_rev;         // T(R,c) = (pred(R) | accept) & bsym[c];
                                   // acc flag = R meets follow[0] (start
                                   // viability, rrx_spans backward pass)
  mutable LazyDfa128 dfa2_seeded;  // the same three, 65..128-state tier
  mutable LazyDfa128 dfa2_plain;
  mutable LazyDfa128 dfa2_rev;

  inline u128 row2(const std::vector<uint64_t>& tab, size_t i) const {
    return (u128)tab[i * 2] | ((u128)tab[i * 2 + 1] << 64);
  }
  inline u128 accept2() const { return row2(accept, 0); }

  // One double-word subset step (words == 2).
  inline u128 step2(u128 D, int sym) const {
    u128 u = 0;
    uint64_t lo = (uint64_t)D, hi = (uint64_t)(D >> 64);
    while (lo) {
      long i = (long)__builtin_ctzll(lo);
      lo &= lo - 1;
      u |= row2(follow, (size_t)i);
    }
    while (hi) {
      long i = 64 + (long)__builtin_ctzll(hi);
      hi &= hi - 1;
      u |= row2(follow, (size_t)i);
    }
    return u & row2(bsym, (size_t)sym);
  }

  inline int32_t dnext2(LazyDfa128& d, int32_t id, int sym,
                        bool seeded) const {
    int32_t& slot = d.rows[(size_t)id * kNSYM + (size_t)sym];
    if (slot >= 0) return slot;
    u128 D = d.bits[(size_t)id];
    if (seeded) D |= (u128)1;
    slot = d.intern(step2(D, sym), accept2());
    return slot;
  }

  inline int32_t dnext2_rev(int32_t id, int sym) const {
    LazyDfa128& d = dfa2_rev;
    int32_t& slot = d.rows[(size_t)id * kNSYM + (size_t)sym];
    if (slot >= 0) return slot;
    u128 R = d.bits[(size_t)id], P = 0;
    uint64_t lo = (uint64_t)R, hi = (uint64_t)(R >> 64);
    while (lo) {
      long j = (long)__builtin_ctzll(lo);
      lo &= lo - 1;
      P |= row2(pred, (size_t)j);
    }
    while (hi) {
      long j = 64 + (long)__builtin_ctzll(hi);
      hi &= hi - 1;
      P |= row2(pred, (size_t)j);
    }
    slot = d.intern((P | accept2()) & row2(bsym, (size_t)sym),
                    row2(follow, 0));
    return slot;
  }

  // One word-tier subset step (words == 1): the union of follow rows of
  // the set bits, masked by the symbol's entry set.
  inline uint64_t step1(uint64_t D, int sym) const {
    uint64_t u = 0;
    while (D) {
      long i = (long)__builtin_ctzll(D);
      D &= D - 1;
      u |= follow[(size_t)i];
    }
    return u & bsym[(size_t)sym];
  }

  // Memoized transition; returns -2 when the cache is full (caller falls
  // back to step1 from dfa.bits[id]).
  inline int32_t dnext(LazyDfa& d, int32_t id, int sym, bool seeded) const {
    int32_t& slot = d.rows[(size_t)id * kNSYM + (size_t)sym];
    if (slot >= 0) return slot;
    uint64_t D = d.bits[(size_t)id];
    if (seeded) D |= 1ull;
    slot = d.intern(step1(D, sym), accept[0]);
    return slot;
  }

  // Memoized REVERSE transition (suffix-viability automaton): j survives
  // iff its label matches and it is accepting or can reach the previous
  // (righter) survivor set in one step.
  inline int32_t dnext_rev(int32_t id, int sym) const {
    LazyDfa& d = dfa_rev;
    int32_t& slot = d.rows[(size_t)id * kNSYM + (size_t)sym];
    if (slot >= 0) return slot;
    uint64_t R = d.bits[(size_t)id], P = 0;
    while (R) {
      long j = (long)__builtin_ctzll(R);
      R &= R - 1;
      P |= pred[(size_t)j];
    }
    slot = d.intern((P | accept[0]) & bsym[(size_t)sym], follow[0]);
    return slot;
  }

  bool step(std::vector<uint64_t>& D, std::vector<uint64_t>& scratch,
            int sym) const {
    // new = (U_{i in D} follow[i]) & bsym[sym] -- the reference's hot loop
    std::fill(scratch.begin(), scratch.end(), 0);
    for (size_t w = 0; w < words; w++) {
      uint64_t x = D[w];
      while (x) {
        long i = (long)(w * 64 + (size_t)__builtin_ctzll(x));
        x &= x - 1;
        const uint64_t* row = &follow[(size_t)i * words];
        for (size_t k = 0; k < words; k++) scratch[k] |= row[k];
      }
    }
    const uint64_t* b = &bsym[(size_t)sym * words];
    uint64_t any = 0;
    for (size_t k = 0; k < words; k++) {
      D[k] = scratch[k] & b[k];
      any |= D[k];
    }
    return any != 0;
  }
};

RrxScanner* rrx_scanner_new(const RrxProgram* p) {
  auto s = std::make_unique<RrxScanner>();
  s->S = p->n_states;
  s->nullable = p->nullable;
  s->words = (size_t)((p->n_states + 63) / 64);
  s->follow.assign((size_t)p->n_states * s->words, 0);
  s->pred.assign((size_t)p->n_states * s->words, 0);
  for (size_t e = 0; e + 1 < p->edges.size(); e += 2) {
    long i = p->edges[e], j = p->edges[e + 1];
    s->follow[(size_t)i * s->words + (size_t)(j >> 6)] |= 1ull << (j & 63);
    s->pred[(size_t)j * s->words + (size_t)(i >> 6)] |= 1ull << (i & 63);
  }
  const size_t nbytes = (kNSYM + 7) / 8;
  s->bsym.assign((size_t)kNSYM * s->words, 0);
  for (long st = 1; st < p->n_states; st++) {
    const uint8_t* lab = &p->labels[(size_t)(st - 1) * nbytes];
    for (int sym = 0; sym < kNSYM; sym++)
      if (lab[sym >> 3] & (1 << (sym & 7)))
        s->bsym[(size_t)sym * s->words + (size_t)(st >> 6)] |=
            1ull << (st & 63);
  }
  s->accept.assign(s->words, 0);
  for (int32_t a : p->accept)
    s->accept[(size_t)(a >> 6)] |= 1ull << (a & 63);
  return s.release();
}

void rrx_scanner_free(RrxScanner* s) { delete s; }

static inline bool hits_accept(const RrxScanner* s,
                               const std::vector<uint64_t>& D) {
  for (size_t k = 0; k < s->words; k++)
    if (D[k] & s->accept[k]) return true;
  return false;
}

// Whole-string acceptance (the reference's verified semantics; oracle
// fullmatch). Stream = BOS | bytes | EOS; position 0 exists on both sides
// of BOS; bytes >= 0x80 are dead symbols.
static long anchored_end(const RrxScanner* s, const uint8_t* text, long n,
                         long start, int longest);

int rrx_fullmatch(const RrxScanner* s, const uint8_t* text, long n) {
  if (n == 0 && s->nullable) return 1;
  if ((s->words == 1 && !s->dfa_plain.full) ||
      (s->words == 2 && !s->dfa2_plain.full))
    // whole-string acceptance == the greedy anchored end from 0 is n
    // (any accept at e == n implies the largest accept end is n)
    return anchored_end(s, text, n, 0, /*longest=*/1) == n;
  std::vector<uint64_t> D(s->words, 0), scratch(s->words, 0);
  D[0] = 1;  // {initial}
  for (long k = 0; k <= n + 1; k++) {
    int sym = k == 0 ? 128 : (k <= n ? (text[k - 1] < 128 ? text[k - 1] : -1)
                                     : 129);
    bool any = sym < 0 ? (std::fill(D.begin(), D.end(), 0), false)
                       : s->step(D, scratch, sym);
    if (k == 0) {
      D[0] |= 1;  // re-inject: position 0 is on both sides of BOS
      any = true;
    }
    long e = k == 0 ? 0 : (k <= n ? k : n);
    if (e == n && hits_accept(s, D)) return 1;
    if (!any && e < n) return 0;
  }
  return 0;
}

// Seeded scan: number of distinct match-end positions (oracle ends());
// *first_end = smallest one or -1. The grep primitive without a device.
// Word-tier (S <= 64) patterns run through the lazy subset DFA: one
// memoized table load per byte in steady state.
static long count_ends_dfa(const RrxScanner* s, const uint8_t* text, long n,
                           long* first_end) {
  LazyDfa& d = s->dfa_seeded;
  // k = 0: seed, consume BOS, re-inject position 0
  uint64_t D0 = s->step1(1ull, kBOS) | 1ull;
  long cnt = 0, first = -1, last = -1;
  if (D0 & s->accept[0] & ~1ull) {
    cnt = 1;
    first = last = 0;
  }
  int32_t id = d.intern(D0, s->accept[0]);
  if (id < 0) return -1;  // cache full: caller re-runs the subset loop
  for (long k = 1; k <= n + 1; k++) {
    if (k <= n && text[k - 1] >= 128) {
      id = d.intern(0, s->accept[0]);  // dead byte clears every path
      if (id < 0) return -1;
      continue;
    }
    int sym = k <= n ? (int)text[k - 1] : kEOS;
    id = s->dnext(d, id, sym, /*seeded=*/true);
    if (id < 0) return -1;
    if (d.acc[(size_t)id]) {
      long e = k <= n ? k : n;
      if (e != last) {
        cnt++;
        last = e;
        if (first < 0) first = e;
      }
    }
  }
  if (first_end) *first_end = first;
  return cnt;
}

// Double-word (65..128 states) twin of count_ends_dfa.
static long count_ends_dfa2(const RrxScanner* s, const uint8_t* text, long n,
                            long* first_end) {
  LazyDfa128& d = s->dfa2_seeded;
  u128 D0 = s->step2((u128)1, kBOS) | (u128)1;
  long cnt = 0, first = -1, last = -1;
  if (D0 & s->accept2() & ~(u128)1) {
    cnt = 1;
    first = last = 0;
  }
  int32_t id = d.intern(D0, s->accept2());
  if (id < 0) return -1;
  for (long k = 1; k <= n + 1; k++) {
    if (k <= n && text[k - 1] >= 128) {
      id = d.intern(0, s->accept2());
      if (id < 0) return -1;
      continue;
    }
    int sym = k <= n ? (int)text[k - 1] : kEOS;
    id = s->dnext2(d, id, sym, /*seeded=*/true);
    if (id < 0) return -1;
    if (d.acc[(size_t)id]) {
      long e = k <= n ? k : n;
      if (e != last) {
        cnt++;
        last = e;
        if (first < 0) first = e;
      }
    }
  }
  if (first_end) *first_end = first;
  return cnt;
}

long rrx_count_ends(const RrxScanner* s, const uint8_t* text, long n,
                    long* first_end) {
  std::vector<uint64_t> D(s->words, 0), scratch(s->words, 0);
  long cnt = 0, first = -1, last = -1;
  if (s->nullable) {  // empty match ends at every position
    if (first_end) *first_end = 0;
    return n + 1;
  }
  if (s->words == 1 && !s->dfa_seeded.full) {
    long r = count_ends_dfa(s, text, n, first_end);
    if (r >= 0) return r;  // cache overflow: redo with the subset loop
  }
  if (s->words == 2 && !s->dfa2_seeded.full) {
    long r = count_ends_dfa2(s, text, n, first_end);
    if (r >= 0) return r;
  }
  for (long k = 0; k <= n + 1; k++) {
    D[0] |= 1;  // fresh seed before every symbol
    int sym = k == 0 ? 128 : (k <= n ? (text[k - 1] < 128 ? text[k - 1] : -1)
                                     : 129);
    if (sym < 0) {
      std::fill(D.begin(), D.end(), 0);
      continue;
    }
    s->step(D, scratch, sym);
    if (k == 0) D[0] |= 1;
    long e = k == 0 ? 0 : (k <= n ? k : n);
    if (hits_accept(s, D) && e != last) {
      cnt++;
      last = e;
      if (first < 0) first = e;
    }
  }
  if (first_end) *first_end = first;
  return cnt;
}

// Word-tier anchored scan through the unseeded lazy DFA; returns -2 when
// the cache overflows (caller re-runs the subset loop).
static long anchored_end_dfa(const RrxScanner* s, const uint8_t* text,
                             long n, long start, int longest) {
  LazyDfa& d = s->dfa_plain;
  long best = (s->accept[0] & 1ull) ? start : -1;  // nullable: empty match
  if (best >= 0 && !longest) return best;
  uint64_t D = 1ull;
  if (start == 0) {
    D = s->step1(1ull, kBOS) | 1ull;  // position 0 on both sides of BOS
    if (D & s->accept[0] & ~1ull) {
      if (!longest) return 0;
      best = 0;
    }
  }
  int32_t id = d.intern(D, s->accept[0]);
  if (id < 0) return -2;
  for (long i = start; i <= n; i++) {
    if (i < n && text[i] >= 128) return best;  // dead byte kills all paths
    int sym = i < n ? (int)text[i] : kEOS;
    id = s->dnext(d, id, sym, /*seeded=*/false);
    if (id < 0) return -2;
    if (d.acc[(size_t)id]) {
      long e = i < n ? i + 1 : n;
      if (!longest) return e;
      best = e;
    }
    if (d.bits[(size_t)id] == 0) return best;  // state set died
  }
  return best;
}

// Double-word twin of anchored_end_dfa.
static long anchored_end_dfa2(const RrxScanner* s, const uint8_t* text,
                              long n, long start, int longest) {
  LazyDfa128& d = s->dfa2_plain;
  long best = (s->accept[0] & 1ull) ? start : -1;
  if (best >= 0 && !longest) return best;
  u128 D = (u128)1;
  if (start == 0) {
    D = s->step2((u128)1, kBOS) | (u128)1;
    if (D & s->accept2() & ~(u128)1) {
      if (!longest) return 0;
      best = 0;
    }
  }
  int32_t id = d.intern(D, s->accept2());
  if (id < 0) return -2;
  for (long i = start; i <= n; i++) {
    if (i < n && text[i] >= 128) return best;
    int sym = i < n ? (int)text[i] : kEOS;
    id = s->dnext2(d, id, sym, /*seeded=*/false);
    if (id < 0) return -2;
    if (d.acc[(size_t)id]) {
      long e = i < n ? i + 1 : n;
      if (!longest) return e;
      best = e;
    }
    if (d.bits[(size_t)id] == 0) return best;
  }
  return best;
}

// Anchored scan from position s: smallest (lazy) / largest (longest) end e
// such that text[s:e] matches, or -1. Mirrors the oracle's first_end_from /
// last_end_from (BOS replay + re-inject at s == 0, EOS as final symbol).
static long anchored_end(const RrxScanner* s, const uint8_t* text, long n,
                         long start, int longest) {
  if (s->words == 1 && !s->dfa_plain.full) {
    long r = anchored_end_dfa(s, text, n, start, longest);
    if (r != -2) return r;
  }
  if (s->words == 2 && !s->dfa2_plain.full) {
    long r = anchored_end_dfa2(s, text, n, start, longest);
    if (r != -2) return r;
  }
  std::vector<uint64_t> D(s->words, 0), scratch(s->words, 0);
  D[0] = 1;  // {initial}
  long best = (s->accept[0] & 1) ? start : -1;  // nullable: empty match
  if (best >= 0 && !longest) return best;
  bool bos = start == 0;
  long total = (bos ? 1 : 0) + (n - start) + 1;  // BOS? + bytes + EOS
  for (long k = 0; k < total; k++) {
    long e;
    int sym;
    if (bos && k == 0) {
      sym = kBOS;
      e = 0;
    } else {
      long i = start + k - (bos ? 1 : 0);  // byte index, or n for EOS
      sym = i < n ? (text[i] < 128 ? text[i] : -1) : kEOS;
      e = i < n ? i + 1 : n;
    }
    if (sym < 0) return best;  // dead byte kills every path from this start
    bool any = s->step(D, scratch, sym);
    if (bos && k == 0) {
      D[0] |= 1;  // position 0 exists on both sides of BOS
      any = true;
    }
    // accept & ~1: state 0 only accepts the empty match, handled above
    uint64_t hit = D[0] & s->accept[0] & ~1ull;
    for (size_t w = 1; w < s->words && !hit; w++) hit = D[w] & s->accept[w];
    if (hit) {
      if (!longest) return e;
      best = e;
    }
    if (!any) return best;
  }
  return best;
}

// Non-overlapping span enumeration, oracle finditer policy: leftmost
// start, then shortest end (longest=0, lazy) or longest end (longest=1,
// greedy POSIX). Fills up to cap spans; returns the TOTAL count (callers
// re-run with a larger cap when count > cap — the device kernels' fixed
// -capacity convention). The leftmost viable start comes from one O(n)
// backward pass over the transposed follow masks (R_t = states whose
// suffix path reaches accept; start s viable iff follow[0] meets R_{s+1}),
// so dead stretches of the input cost no anchored rescans.
long rrx_spans(const RrxScanner* s, const uint8_t* text, long n, int longest,
               long* starts, long* ends, long cap) {
  std::vector<uint64_t> viable((size_t)(n + 2 + 63) / 64, 0);
  if (s->nullable) {
    // empty match everywhere: every position is a viable start
    for (long i = 0; i <= n; i++)
      viable[(size_t)(i >> 6)] |= 1ull << (i & 63);
  } else {
    bool dfa_done = false;
    if (s->words == 1 && !s->dfa_rev.full) {
      // word tier: the viability pass through the reverse lazy DFA
      int32_t id = s->dfa_rev.intern(0, s->follow[0]);
      long t = n + 1;
      for (; t >= 1 && id >= 0; t--) {
        if (t <= n && text[t - 1] >= 128) {
          id = s->dfa_rev.intern(0, s->follow[0]);
          continue;
        }
        int sym = t == n + 1 ? kEOS : (int)text[t - 1];
        id = s->dnext_rev(id, sym);
        if (id >= 0 && s->dfa_rev.acc[(size_t)id])
          viable[(size_t)((t - 1) >> 6)] |= 1ull << ((t - 1) & 63);
      }
      if (id >= 0) {
        dfa_done = true;
      } else {
        std::fill(viable.begin(), viable.end(), 0);  // redo generically
      }
    }
    if (!dfa_done && s->words == 2 && !s->dfa2_rev.full) {
      int32_t id = s->dfa2_rev.intern(0, s->row2(s->follow, 0));
      long t = n + 1;
      for (; t >= 1 && id >= 0; t--) {
        if (t <= n && text[t - 1] >= 128) {
          id = s->dfa2_rev.intern(0, s->row2(s->follow, 0));
          continue;
        }
        int sym = t == n + 1 ? kEOS : (int)text[t - 1];
        id = s->dnext2_rev(id, sym);
        if (id >= 0 && s->dfa2_rev.acc[(size_t)id])
          viable[(size_t)((t - 1) >> 6)] |= 1ull << ((t - 1) & 63);
      }
      if (id >= 0) {
        dfa_done = true;
      } else {
        std::fill(viable.begin(), viable.end(), 0);
      }
    }
    if (!dfa_done) {
    std::vector<uint64_t> R(s->words, 0), P(s->words, 0);
    // stream steps t = n+1 (EOS) down to 1; R = R_t after each iteration
    for (long t = n + 1; t >= 1; t--) {
      int sym = t == n + 1 ? kEOS
                           : (text[t - 1] < 128 ? (int)text[t - 1] : -1);
      if (sym < 0) {
        std::fill(R.begin(), R.end(), 0);
      } else {
        std::fill(P.begin(), P.end(), 0);
        for (size_t w = 0; w < s->words; w++) {
          uint64_t x = R[w];
          while (x) {
            long j = (long)(w * 64 + (size_t)__builtin_ctzll(x));
            x &= x - 1;
            const uint64_t* row = &s->pred[(size_t)j * s->words];
            for (size_t k = 0; k < s->words; k++) P[k] |= row[k];
          }
        }
        const uint64_t* b = &s->bsym[(size_t)sym * s->words];
        for (size_t k = 0; k < s->words; k++)
          R[k] = (P[k] | s->accept[k]) & b[k];
      }
      uint64_t meet = 0;  // start s = t-1 viable iff follow[0] meets R_t
      for (size_t k = 0; k < s->words; k++) meet |= s->follow[k] & R[k];
      if (meet)
        viable[(size_t)((t - 1) >> 6)] |= 1ull << ((t - 1) & 63);
    }
    }
    // s = 0 consumes BOS first (^-anchored paths): direct probe
    if (anchored_end(s, text, n, 0, 0) >= 0)
      viable[0] |= 1;
    else
      viable[0] &= ~1ull;
  }
  long pos = 0, cnt = 0;
  while (pos <= n) {
    long st = -1;
    for (long w = pos >> 6; w < (long)viable.size(); w++) {
      uint64_t x = viable[(size_t)w];
      if (w == (pos >> 6)) x &= ~0ull << (pos & 63);
      if (x) {
        st = w * 64 + (long)__builtin_ctzll(x);
        break;
      }
    }
    if (st < 0 || st > n) break;
    long e = anchored_end(s, text, n, st, longest);
    if (e < 0) {  // stale viability (cannot happen; guard anyway)
      pos = st + 1;
      continue;
    }
    if (cnt < cap) {
      starts[cnt] = st;
      ends[cnt] = e;
    }
    cnt++;
    pos = e > st ? e : st + 1;
  }
  return cnt;
}

// Any match in text[0:n] (seeded scan, early exit at the first accept) —
// the grep primitive for one record.
static int line_any(const RrxScanner* s, const uint8_t* text, long n) {
  if (s->nullable) return 1;
  if (s->words == 1 && !s->dfa_seeded.full) {
    uint64_t D0 = s->step1(1ull, kBOS) | 1ull;
    if (D0 & s->accept[0] & ~1ull) return 1;
    int32_t id = s->dfa_seeded.intern(D0, s->accept[0]);
    for (long k = 1; id >= 0 && k <= n + 1; k++) {
      if (k <= n && text[k - 1] >= 128) {
        id = s->dfa_seeded.intern(0, s->accept[0]);
        continue;
      }
      int sym = k <= n ? (int)text[k - 1] : kEOS;
      id = s->dnext(s->dfa_seeded, id, sym, /*seeded=*/true);
      if (id >= 0 && s->dfa_seeded.acc[(size_t)id]) return 1;
    }
    if (id >= 0) return 0;  // scanned everything, no accept
  }
  if (s->words == 2 && !s->dfa2_seeded.full) {
    u128 D0 = s->step2((u128)1, kBOS) | (u128)1;
    if (D0 & s->accept2() & ~(u128)1) return 1;
    int32_t id = s->dfa2_seeded.intern(D0, s->accept2());
    for (long k = 1; id >= 0 && k <= n + 1; k++) {
      if (k <= n && text[k - 1] >= 128) {
        id = s->dfa2_seeded.intern(0, s->accept2());
        continue;
      }
      int sym = k <= n ? (int)text[k - 1] : kEOS;
      id = s->dnext2(s->dfa2_seeded, id, sym, /*seeded=*/true);
      if (id >= 0 && s->dfa2_seeded.acc[(size_t)id]) return 1;
    }
    if (id >= 0) return 0;
  }
  std::vector<uint64_t> D(s->words, 0), scratch(s->words, 0);
  for (long k = 0; k <= n + 1; k++) {
    D[0] |= 1;
    int sym = k == 0 ? kBOS
                     : (k <= n ? (text[k - 1] < 128 ? (int)text[k - 1] : -1)
                               : kEOS);
    if (sym < 0) {
      std::fill(D.begin(), D.end(), 0);
      continue;
    }
    s->step(D, scratch, sym);
    if (k == 0) D[0] |= 1;
    if (hits_accept(s, D)) return 1;
  }
  return 0;
}

// Grep over newline-delimited records in ONE call: out_hits bit r = some
// match in record r (seeded, early exit per record). Returns the record
// count, or -1 if it exceeds max_records. The whole-file CLI grep path —
// no per-line language-boundary crossings.
long rrx_grep_lines(const RrxScanner* s, const uint8_t* buf, long n,
                    uint8_t* out_hits, long max_records) {
  long rec = 0, start = 0;
  for (long i = 0; i <= n; i++) {
    if (i == n || buf[i] == '\n') {
      if (i == n && i == start) break;  // no trailing record
      if (rec >= max_records) return -1;
      if (line_any(s, buf + start, i - start))
        out_hits[rec >> 3] |= (uint8_t)(1u << (rec & 7));
      rec++;
      start = i + 1;
    }
  }
  return rec;
}

// ---------------------------------------------------------------------------
// Corpus packer (data-loader): newline records -> padded [B, L] + lengths.
// Returns the record count, or -1 if more than max_records records exist.
// Records longer than L are truncated to L (caller picks L = max length,
// discoverable via rrx_scan_records).
// ---------------------------------------------------------------------------

long rrx_scan_records(const uint8_t* buf, long n, long* max_len) {
  long count = 0, cur = 0, mx = 0;
  for (long i = 0; i < n; i++) {
    if (buf[i] == '\n') {
      count++;
      if (cur > mx) mx = cur;
      cur = 0;
    } else {
      cur++;
    }
  }
  if (cur > 0) {  // trailing record without newline
    count++;
    if (cur > mx) mx = cur;
  }
  if (max_len) *max_len = mx;
  return count;
}

long rrx_pack_lines(const uint8_t* buf, long n, long max_records, long L,
                    uint8_t* data, int32_t* lengths) {
  long rec = 0, start = 0;
  for (long i = 0; i <= n; i++) {
    if (i == n || buf[i] == '\n') {
      if (i == n && i == start) break;  // no trailing record
      if (rec >= max_records) return -1;
      long len = i - start;
      if (len > L) len = L;
      std::memcpy(data + rec * L, buf + start, len);
      if (len < L) std::memset(data + rec * L + len, 0, L - len);
      lengths[rec] = (int32_t)len;
      rec++;
      start = i + 1;
    }
  }
  return rec;
}

}  // extern "C"
