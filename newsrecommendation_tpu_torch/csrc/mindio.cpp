// mindio: the port's native MIND behaviors parser (host code, built with
// g++; see data/native_loader.py).
//
// It mmaps a behaviors shard and fills the dense arrays that the loader
// returns, equal element for element to its pure-Python parser:
//   train:  history (N,L) int32 front-padded, history_mask (N,L) f32,
//           pos (N,) int32, neg (N,K) int32
//   eval:   history (N,L), history_mask (N,L), candidates (N,C) int32,
//           labels (N,C) f32, candidate_mask (N,C) f32
// Unknown doc ids map to 0; a history keeps its most recent L clicks,
// front-padded with 0; a train line takes the first token of its pos
// field and at most K negatives, zero-filled; an eval candidate splits on
// its last '-'.
//
// Lines end as Python's universal newlines end them ("\n", "\r\n" or a
// lone "\r"), and tokens split on ASCII whitespace as str.split() splits
// them, so a CRLF file gives the same arrays as an LF one. A line with too
// few fields, an empty pos field, or a candidate without "-<int>" is an
// error (return -2, with the 1-based line number in out->n); an empty file
// gives N = 0.
//
// Zero dependencies; C ABI for ctypes. Every buffer is malloc'd here and
// released with mindio_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <string>
#include <string_view>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

// FNV-1a: doc ids are short, and over them it is faster than the
// library's hash.
struct Fnv1a {
  size_t operator()(std::string_view v) const {
    uint64_t h = 1469598103934665603ull;
    for (unsigned char c : v) h = (h ^ c) * 1099511628211ull;
    return static_cast<size_t>(h);
  }
};

// Keys live in `keys` (a deque never moves them); the map looks a token up
// by view, with no string built for it.
struct Index {
  std::deque<std::string> keys;
  std::unordered_map<std::string_view, int32_t, Fnv1a> map;
};

// The ASCII whitespace of str.split(), less '\t' and '\n', which never
// occur inside a field: ' ', '\r', '\v', '\f' and '\x1c'-'\x1f'.
struct SpaceTable {
  bool t[256] = {};
  SpaceTable() {
    for (unsigned char c : {' ', '\r', '\v', '\f', '\x1c', '\x1d', '\x1e',
                            '\x1f'})
      t[c] = true;
  }
};
const SpaceTable kSpace;

inline bool is_space(char c) { return kSpace.t[static_cast<unsigned char>(c)]; }

// Call fn(token) for each whitespace-separated token of [begin, end).
template <typename Fn>
inline void for_each_token(const char* begin, const char* end, Fn&& fn) {
  const char* p = begin;
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    const char* tok = p;
    while (p < end && !is_space(*p)) ++p;
    if (p > tok) fn(std::string_view(tok, static_cast<size_t>(p - tok)));
  }
}

inline int32_t lookup(const Index* idx, std::string_view v) {
  auto it = idx->map.find(v);
  return it == idx->map.end() ? 0 : it->second;
}

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
};

// 0 on success (an empty file maps to size 0), -1 if it cannot be read.
int map_file(const char* path, MappedFile* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return -1;
  struct stat st;
  if (fstat(m->fd, &st) != 0) return -1;
  m->size = static_cast<size_t>(st.st_size);
  if (m->size == 0) return 0;
  void* p = mmap(nullptr, m->size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) return -1;
  m->data = static_cast<const char*>(p);
  return 0;
}

void unmap_file(MappedFile* m) {
  if (m->data) munmap(const_cast<char*>(m->data), m->size);
  if (m->fd >= 0) close(m->fd);
}

// One line of the file per call, its terminator left out: "\n", "\r\n" and
// a lone "\r" each end a line; the last line needs no terminator.
struct Lines {
  const char* p;
  const char* end;
  bool next(const char** begin, const char** line_end) {
    if (p >= end) return false;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* q = nl ? nl : end;
    const char* cr = static_cast<const char*>(memchr(p, '\r', q - p));
    *begin = p;
    if (cr) {  // "\r\n" ends the line as "\n" does; a lone "\r" ends it
      *line_end = cr;
      p = cr + 1 == nl ? nl + 1 : cr + 1;
    } else {
      *line_end = q;
      p = nl ? nl + 1 : end;
    }
    return true;
  }
};

int64_t count_lines(const MappedFile& m) {
  Lines lines{m.data, m.data + m.size};
  const char *b, *e;
  int64_t n = 0;
  while (lines.next(&b, &e)) ++n;
  return n;
}

// history field -> front-padded index row + mask row: the LAST L entries.
void fill_history(const Index* idx, const char* begin, const char* end,
                  int32_t L, std::vector<int32_t>* ids, int32_t* hist_row,
                  float* mask_row) {
  ids->clear();
  for_each_token(begin, end,
                 [&](std::string_view v) { ids->push_back(lookup(idx, v)); });
  const int64_t n = static_cast<int64_t>(ids->size());
  const int64_t keep = n < L ? n : L;
  const int64_t pad = L - keep;
  for (int64_t i = 0; i < pad; ++i) {
    hist_row[i] = 0;
    mask_row[i] = 0.0f;
  }
  for (int64_t i = 0; i < keep; ++i) {
    hist_row[pad + i] = (*ids)[n - keep + i];
    mask_row[pad + i] = 1.0f;
  }
}

struct Fields {
  const char* f[8];
  const char* fe[8];
  int count;
};

// Split a line into up to 8 tab fields.
inline Fields split_line(const char* begin, const char* end) {
  Fields out;
  out.count = 0;
  const char* tok = begin;
  for (const char* p = begin; p <= end && out.count < 8; ++p) {
    if (p == end || *p == '\t') {
      out.f[out.count] = tok;
      out.fe[out.count] = p;
      ++out.count;
      tok = p + 1;
    }
  }
  return out;
}

// The integer after a candidate's last '-', as int() reads it: an optional
// sign and at least one digit. False if there is none.
inline bool parse_label(const char* p, const char* end, float* out) {
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = *p++ == '-';
  if (p == end) return false;
  int64_t v = 0;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
  }
  *out = static_cast<float>(neg ? -v : v);
  return true;
}

template <typename T>
T* alloc(int64_t count) {
  // at least one element, so an empty result is a valid pointer too
  return static_cast<T*>(calloc(count > 0 ? count : 1, sizeof(T)));
}

}  // namespace

extern "C" {

// ---- doc-id index --------------------------------------------------------

void* mindio_index_create() { return new Index(); }

void mindio_index_add(void* handle, const char* id, int32_t value) {
  Index* idx = static_cast<Index*>(handle);
  if (idx->map.count(id)) return;  // the first value stays, as emplace's
  idx->keys.emplace_back(id);
  idx->map.emplace(idx->keys.back(), value);
}

void mindio_index_free(void* handle) { delete static_cast<Index*>(handle); }

// ---- prepared-train-shard parser ----------------------------------------
// File format: iid \t uid \t time \t history \t pos \t "neg1 neg2 ..."
// (prepare.py output). Returns the row count; -1 if the file cannot be
// read; -2 on a malformed line, whose 1-based number is then in out->n.

struct TrainResult {
  int64_t n;
  int32_t* history;      // (n, L)
  float* history_mask;   // (n, L)
  int32_t* pos;          // (n,)
  int32_t* neg;          // (n, K)
};

void mindio_free(void* p) { free(p); }

static void free_train(TrainResult* out) {
  free(out->history);
  free(out->history_mask);
  free(out->pos);
  free(out->neg);
  out->history = out->pos = out->neg = nullptr;
  out->history_mask = nullptr;
}

int64_t mindio_parse_train(void* index_handle, const char* path, int32_t L,
                           int32_t K, TrainResult* out) {
  const Index* idx = static_cast<const Index*>(index_handle);
  MappedFile m;
  if (map_file(path, &m) != 0) {
    unmap_file(&m);
    return -1;
  }
  const int64_t n_lines = count_lines(m);
  out->n = 0;
  out->history = alloc<int32_t>(n_lines * L);
  out->history_mask = alloc<float>(n_lines * L);
  out->pos = alloc<int32_t>(n_lines);
  out->neg = alloc<int32_t>(n_lines * K);

  std::vector<int32_t> ids;
  ids.reserve(64);
  Lines lines{m.data, m.data + m.size};
  const char *line, *line_end;
  while (lines.next(&line, &line_end)) {
    Fields f = split_line(line, line_end);
    const int64_t r = out->n;
    int32_t pos_id = 0;
    bool got = false;
    if (f.count >= 6) {
      for_each_token(f.f[4], f.fe[4], [&](std::string_view v) {
        if (!got) pos_id = lookup(idx, v);
        got = true;
      });
    }
    if (!got) {  // too few fields, or no positive
      unmap_file(&m);
      free_train(out);
      out->n = r + 1;
      return -2;
    }
    fill_history(idx, f.f[3], f.fe[3], L, &ids, out->history + r * L,
                 out->history_mask + r * L);
    out->pos[r] = pos_id;
    int32_t k = 0;
    for_each_token(f.f[5], f.fe[5], [&](std::string_view v) {
      if (k < K) out->neg[r * K + k++] = lookup(idx, v);
    });
    ++out->n;  // neg's unfilled tail is calloc's zeros
  }
  unmap_file(&m);
  return out->n;
}

// ---- raw-eval-shard parser ----------------------------------------------
// File format: iid \t uid \t time \t history \t "Nx-0 Ny-1 ..."
// (raw behaviors.tsv). C = fixed candidate width (0-padded). Returns as
// mindio_parse_train does.

struct EvalResult {
  int64_t n;
  int32_t* history;        // (n, L)
  float* history_mask;     // (n, L)
  int32_t* candidates;     // (n, C)
  float* labels;           // (n, C)
  float* candidate_mask;   // (n, C)
  int64_t truncated;       // impressions with more than C candidates
  int64_t max_width;       // widest impression observed (pre-truncation)
};

static void free_eval(EvalResult* out) {
  free(out->history);
  free(out->history_mask);
  free(out->candidates);
  free(out->labels);
  free(out->candidate_mask);
  out->history = out->candidates = nullptr;
  out->history_mask = out->labels = out->candidate_mask = nullptr;
}

int64_t mindio_parse_eval(void* index_handle, const char* path, int32_t L,
                          int32_t C, EvalResult* out) {
  const Index* idx = static_cast<const Index*>(index_handle);
  MappedFile m;
  if (map_file(path, &m) != 0) {
    unmap_file(&m);
    return -1;
  }
  const int64_t n_lines = count_lines(m);
  out->n = 0;
  out->truncated = 0;
  out->max_width = 0;
  out->history = alloc<int32_t>(n_lines * L);
  out->history_mask = alloc<float>(n_lines * L);
  out->candidates = alloc<int32_t>(n_lines * C);
  out->labels = alloc<float>(n_lines * C);
  out->candidate_mask = alloc<float>(n_lines * C);

  std::vector<int32_t> ids;
  ids.reserve(64);
  Lines lines{m.data, m.data + m.size};
  const char *line, *line_end;
  while (lines.next(&line, &line_end)) {
    Fields f = split_line(line, line_end);
    const int64_t r = out->n;
    bool ok = f.count >= 5;
    int32_t c = 0;      // candidates kept (<= C)
    int64_t total = 0;  // candidates present in the line
    if (ok) {
      for_each_token(f.f[4], f.fe[4], [&](std::string_view v) {
        const size_t dash = v.rfind('-');
        float label = 0.0f;
        if (dash == std::string_view::npos ||
            !parse_label(v.data() + dash + 1, v.data() + v.size(), &label)) {
          ok = false;
          return;
        }
        ++total;
        if (c >= C) return;
        out->candidates[r * C + c] = lookup(idx, v.substr(0, dash));
        out->labels[r * C + c] = label;
        out->candidate_mask[r * C + c] = 1.0f;
        ++c;
      });
    }
    if (!ok) {
      unmap_file(&m);
      free_eval(out);
      out->n = r + 1;
      return -2;
    }
    fill_history(idx, f.f[3], f.fe[3], L, &ids, out->history + r * L,
                 out->history_mask + r * L);
    if (total > C) ++out->truncated;
    if (total > out->max_width) out->max_width = total;
    ++out->n;
  }
  unmap_file(&m);
  return out->n;
}

}  // extern "C"
