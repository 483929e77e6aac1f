// tpusparse_torch native host library: the port's own copy of the JAX
// package's host helpers, built by g++ at first use
// (tpusparse_torch/kernels/build.py::host_library) and called through ctypes
// (tpusparse_torch/native.py).  The packers' chunk and tile walks and the
// .mtx parser are O(nnz) loops that numpy runs one chunk or one run at a
// time; here they are one pass.  C ABI throughout; the buffers that
// ts_parse_mtx allocates are released with ts_free.
//
// Components:
//   ts_parse_mtx        Matrix-Market / bare-COO loader (%comments, banner,
//                       pattern/symmetric/skew-symmetric, 1-based ->
//                       0-based), row-major sorted on return.
//   ts_merge_path_cuts  merge-path equal-work partition (binary-search form).
//   ts_bucket_pack      counting-sort scatter of (a, b, v) payloads into
//                       padded [n_buckets, cap] slots.
//   ts_span_count/fill  the span chunk walk (span, radix, segment-span).
//   ts_span_*_al        the aligned-window chunk walk (dg).
//   ts_dgt_runs[_multi] the dgt packers' tile walks over (bucket, window)
//                       runs.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

void ts_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Matrix-Market parser
// ---------------------------------------------------------------------------

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Parses the file at `path`.  Outputs malloc'd arrays (caller ts_free's).
// Returns 0 on success, negative error codes otherwise.
//   -1 open failed   -2 malformed size line   -3 entry out of range
//   -5 diagonal entry in a skew-symmetric matrix
int ts_parse_mtx(const char* path,
                 int64_t** out_rows, int64_t** out_cols, double** out_vals,
                 int64_t* out_m, int64_t* out_n, int64_t* out_nnz) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)size + 1);
  size_t rd = fread(buf.data(), 1, (size_t)size, f);
  fclose(f);
  buf[rd] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + rd;

  bool symmetric = false, skew = false, pattern = false;
  bool first = true;
  int64_t m = -1, n = -1, declared = -1;

  // header + size line
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    if (*p == '%') {
      if (first && strncmp(p, "%%MatrixMarket", 14) == 0) {
        const char* q = p;
        const char* le = q;
        while (le < end && *le != '\n') ++le;
        std::vector<char> line(q, le);
        line.push_back('\0');
        for (char& c : line) c = (char)tolower((unsigned char)c);
        if (strstr(line.data(), "skew-symmetric")) skew = true;
        if (strstr(line.data(), "symmetric")) symmetric = true;
        if (strstr(line.data(), "pattern")) pattern = true;
      }
      first = false;
      p = next_line(p, end);
      continue;
    }
    first = false;
    // size line
    char* q;
    long long a = strtoll(p, &q, 10);
    if (q == p) return -2;
    p = q;
    long long b = strtoll(p, &q, 10);
    if (q == p) return -2;
    p = q;
    p = skip_ws(p, end);
    if (p < end && *p != '\n') {
      long long c = strtoll(p, &q, 10);
      if (q != p) { declared = c; p = q; }
    }
    m = a; n = b;
    p = next_line(p, end);
    break;
  }
  if (m < 0 || n < 0) return -2;

  size_t reserve = declared > 0 ? (size_t)declared * (symmetric ? 2 : 1) : 1024;
  std::vector<int64_t> rows, cols;
  std::vector<double> vals;
  rows.reserve(reserve); cols.reserve(reserve); vals.reserve(reserve);

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    if (*p == '%') { p = next_line(p, end); continue; }
    char* q;
    long long r = strtoll(p, &q, 10);
    if (q == p) { p = next_line(p, end); continue; }
    p = q;
    long long c = strtoll(p, &q, 10);
    if (q == p) return -2;
    p = q;
    double v = 1.0;
    p = skip_ws(p, end);
    if (!pattern && p < end && *p != '\n') {
      v = strtod(p, &q);
      if (q != p) p = q;
    }
    r -= 1; c -= 1;
    if (r < 0 || r >= m || c < 0 || c >= n) return -3;
    if (skew && r == c) return -5;  // skew-symmetric forbids diagonal entries
    rows.push_back(r); cols.push_back(c); vals.push_back(v);
    if (symmetric && r != c) {
      // skew-symmetric: A = -A^T, the mirrored entry is negated
      rows.push_back(c); cols.push_back(r); vals.push_back(skew ? -v : v);
    }
    p = next_line(p, end);
  }

  // row-major sort (rows, then cols), stable payload carry
  int64_t nnz = (int64_t)rows.size();
  std::vector<int64_t> idx(nnz);
  for (int64_t i = 0; i < nnz; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(), [&](int64_t x, int64_t y) {
    if (rows[x] != rows[y]) return rows[x] < rows[y];
    if (cols[x] != cols[y]) return cols[x] < cols[y];
    return x < y;
  });

  int64_t* orows = (int64_t*)malloc(sizeof(int64_t) * (size_t)std::max<int64_t>(nnz, 1));
  int64_t* ocols = (int64_t*)malloc(sizeof(int64_t) * (size_t)std::max<int64_t>(nnz, 1));
  double* ovals = (double*)malloc(sizeof(double) * (size_t)std::max<int64_t>(nnz, 1));
  if (!orows || !ocols || !ovals) { free(orows); free(ocols); free(ovals); return -4; }
  for (int64_t i = 0; i < nnz; ++i) {
    orows[i] = rows[idx[i]];
    ocols[i] = cols[idx[i]];
    ovals[i] = vals[idx[i]];
  }
  *out_rows = orows; *out_cols = ocols; *out_vals = ovals;
  *out_m = m; *out_n = n; *out_nnz = nnz;
  return 0;
}

// ---------------------------------------------------------------------------
// Merge-path equal-work partition
// ---------------------------------------------------------------------------

// Cuts the (rows + nnz) merge path every `work` items.  row_ptr has m+1
// entries.  out_rows/out_nzs must hold n_cuts+1 entries where
// n_cuts = ceil((m + nnz) / work).  Writes boundary (row, nz) pairs,
// final entry = (m, nnz).  Returns n_cuts.
int64_t ts_merge_path_cuts(const int64_t* row_ptr, int64_t m, int64_t nnz,
                           int64_t work, int64_t* out_rows, int64_t* out_nzs) {
  int64_t total = m + nnz;
  int64_t n_cuts = work > 0 ? (total + work - 1) / work : 1;
  if (n_cuts < 1) n_cuts = 1;
  for (int64_t i = 0; i <= n_cuts; ++i) {
    int64_t diag = std::min(i * work, total);
    // binary search: r = #row-steps taken, z = diag - r = #nz-steps,
    // invariant row_ptr[r] >= z  <=>  all z nz belong to the first r rows
    int64_t lo = std::max<int64_t>(0, diag - nnz), hi = std::min(diag, m);
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (row_ptr[mid] < diag - mid) lo = mid + 1; else hi = mid;
    }
    out_rows[i] = lo;
    out_nzs[i] = diag - lo;
  }
  return n_cuts;
}

// ---------------------------------------------------------------------------
// Bucket pack (counting-sort scatter into padded slots)
// ---------------------------------------------------------------------------

// key[i] in [0, n_buckets): destination bucket of nz i.  Payloads a, b
// (int32) and v (float) land at out_*[key, slot] where slot is the running
// count per bucket (stable in input order).  out buffers are
// [n_buckets * cap], zeroed here.  Returns max bucket occupancy, or -1 if
// any bucket exceeds cap.
int64_t ts_bucket_pack(const int64_t* key, int64_t nnz,
                       int64_t n_buckets, int64_t cap,
                       const int32_t* a, const int32_t* b, const float* v,
                       int32_t* out_a, int32_t* out_b, float* out_v) {
  memset(out_a, 0, sizeof(int32_t) * (size_t)(n_buckets * cap));
  memset(out_b, 0, sizeof(int32_t) * (size_t)(n_buckets * cap));
  memset(out_v, 0, sizeof(float) * (size_t)(n_buckets * cap));
  std::vector<int64_t> fill((size_t)n_buckets, 0);
  int64_t maxfill = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t kk = key[i];
    if (kk < 0 || kk >= n_buckets) return -1;
    int64_t s = fill[(size_t)kk]++;
    if (s >= cap) return -1;
    out_a[kk * cap + s] = a[i];
    out_b[kk * cap + s] = b[i];
    out_v[kk * cap + s] = v[i];
    if (fill[(size_t)kk] > maxfill) maxfill = fill[(size_t)kk];
  }
  return maxfill;
}

// Per-bucket occupancy counts (helper for budget sizing before packing).
void ts_bucket_counts(const int64_t* key, int64_t nnz, int64_t n_buckets,
                      int64_t* out_counts) {
  memset(out_counts, 0, sizeof(int64_t) * (size_t)n_buckets);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t kk = key[i];
    if (kk >= 0 && kk < n_buckets) ++out_counts[kk];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Span-format packer (chunk descriptors + padded fill in one pass)
// ---------------------------------------------------------------------------

extern "C" {

// Phase 1: count chunks per program.  Inputs are the per-program
// column-sorted nz stream (cols) and program start offsets (p_starts,
// p_count+1 entries).  A chunk ends when it reaches g nz or its column span
// would exceed span_budget (window start rounded down to a multiple of 8).
// Writes out_nc[p]; returns max chunk count.
int64_t ts_span_count(const int64_t* cols, const int64_t* p_starts,
                      int64_t p_count, int64_t g, int64_t span_budget,
                      int64_t* out_nc) {
  int64_t max_nc = 1;
  for (int64_t p = 0; p < p_count; ++p) {
    int64_t i = p_starts[p], hi = p_starts[p + 1], nc = 0;
    while (i < hi) {
      int64_t c0 = cols[i] & ~7LL;
      int64_t j = i;
      int64_t jcap = std::min(i + g, hi);
      while (j < jcap && cols[j] - c0 < span_budget + 8) ++j;
      ++nc;
      i = j;
    }
    if (nc == 0) nc = 1;
    out_nc[p] = nc;
    if (nc > max_nc) max_nc = nc;
  }
  return max_nc;
}

// Phase 2: fill padded [p_count, nc, g] arrays (callers pass zeroed buffers
// of that size) plus c0 [p_count, nc].  Same chunking walk as ts_span_count.
// out_dest (optional, may be null): flat packed position of each input nz,
// enabling values-only format updates.
void ts_span_fill(const int64_t* cols, const int64_t* lrow, const float* vals,
                  const int64_t* p_starts, int64_t p_count, int64_t g,
                  int64_t span_budget, int64_t nc,
                  int32_t* out_c0, int32_t* out_cols, int32_t* out_lrow,
                  float* out_vals, int64_t* out_dest) {
  for (int64_t p = 0; p < p_count; ++p) {
    int64_t i = p_starts[p], hi = p_starts[p + 1], ci = 0;
    while (i < hi && ci < nc) {
      int64_t c0 = cols[i] & ~7LL;
      int64_t j = i;
      int64_t jcap = std::min(i + g, hi);
      while (j < jcap && cols[j] - c0 < span_budget + 8) ++j;
      out_c0[p * nc + ci] = (int32_t)c0;
      int64_t base = (p * nc + ci) * g;
      for (int64_t t = i; t < j; ++t) {
        out_cols[base + (t - i)] = (int32_t)(cols[t] - c0);
        out_lrow[base + (t - i)] = (int32_t)lrow[t];
        out_vals[base + (t - i)] = vals[t];
        if (out_dest) out_dest[t] = base + (t - i);
      }
      ++ci;
      i = j;
    }
  }
}

// Aligned-window variant (dg_gather family): the window start is aligned
// DOWN to `align` at chunk creation, so the full window W is usable from an
// aligned base (the plain chunker aligns to 8 and would need `align` of
// realign headroom, which at align=W degenerates to zero budget).
int64_t ts_span_count_al(const int64_t* cols, const int64_t* p_starts,
                         int64_t p_count, int64_t g, int64_t window,
                         int64_t align, int64_t* out_nc) {
  int64_t max_nc = 1;
  for (int64_t p = 0; p < p_count; ++p) {
    int64_t i = p_starts[p], hi = p_starts[p + 1], nc = 0;
    while (i < hi) {
      int64_t c0 = cols[i] & ~(align - 1);
      int64_t j = i;
      int64_t jcap = std::min(i + g, hi);
      while (j < jcap && cols[j] - c0 < window) ++j;
      ++nc;
      i = j;
    }
    if (nc == 0) nc = 1;
    out_nc[p] = nc;
    if (nc > max_nc) max_nc = nc;
  }
  return max_nc;
}

void ts_span_fill_al(const int64_t* cols, const int64_t* lrow,
                     const float* vals, const int64_t* p_starts,
                     int64_t p_count, int64_t g, int64_t window,
                     int64_t align, int64_t nc,
                     int32_t* out_c0, int32_t* out_cols, int32_t* out_lrow,
                     float* out_vals, int64_t* out_dest) {
  for (int64_t p = 0; p < p_count; ++p) {
    int64_t i = p_starts[p], hi = p_starts[p + 1], ci = 0;
    while (i < hi && ci < nc) {
      int64_t c0 = cols[i] & ~(align - 1);
      int64_t j = i;
      int64_t jcap = std::min(i + g, hi);
      while (j < jcap && cols[j] - c0 < window) ++j;
      out_c0[p * nc + ci] = (int32_t)c0;
      int64_t base = (p * nc + ci) * g;
      for (int64_t t = i; t < j; ++t) {
        out_cols[base + (t - i)] = (int32_t)(cols[t] - c0);
        out_lrow[base + (t - i)] = (int32_t)lrow[t];
        out_vals[base + (t - i)] = vals[t];
        if (out_dest) out_dest[t] = base + (t - i);
      }
      ++ci;
      i = j;
    }
  }
}


// ---------------------------------------------------------------------------
// dgt greedy run walk (kernels/dgt_gather._dgt_walk inner loop): per
// (bucket, 128-col window) run, top up the carried open tile when the run's
// window lies within [open_w, open_w + nw) and class room remains, else
// open ceil(max_class/cap) fresh tiles.  Single pass over runs; outputs
// feed the vectorized numpy slot assignment.
extern "C" void ts_dgt_runs(
    const int64_t* run_b, const int64_t* run_win, const int64_t* cnt,
    int64_t n_runs, int64_t ncls, int64_t cap, int64_t nw, int64_t n_buckets,
    int64_t* take, int64_t* open_tile, int64_t* open_fill, int64_t* join_pos,
    int64_t* new_base, int64_t* fresh_n, int64_t* tot_tiles) {
  (void)n_buckets;
  std::vector<int64_t> room(ncls, 0);
  bool have_room = false;
  int64_t cur_b = -1, open_w = -1, ntiles = 0;
  for (int64_t r = 0; r < n_runs; ++r) {
    int64_t b = run_b[r];
    if (b != cur_b) {
      if (cur_b >= 0) tot_tiles[cur_b] = ntiles;
      cur_b = b;
      ntiles = 0;
      have_room = false;
      open_w = -1;
    }
    const int64_t* c = cnt + r * ncls;
    int64_t w = run_win[r];
    int64_t take_sum = 0;
    if (have_room && w - open_w >= 0 && w - open_w < nw) {
      for (int64_t k = 0; k < ncls; ++k)
        take_sum += std::min(room[k], c[k]);
    }
    int64_t left_max = 0;
    if (take_sum > 0) {
      open_tile[r] = ntiles - 1;
      join_pos[r] = w - open_w;
      for (int64_t k = 0; k < ncls; ++k) {
        int64_t t = std::min(room[k], c[k]);
        take[r * ncls + k] = t;
        open_fill[r * ncls + k] = cap - room[k];
        room[k] -= t;
        left_max = std::max(left_max, c[k] - t);
      }
    } else {
      for (int64_t k = 0; k < ncls; ++k)
        left_max = std::max(left_max, c[k]);
    }
    if (left_max > 0) {
      int64_t n_new = (left_max + cap - 1) / cap;
      new_base[r] = ntiles;
      fresh_n[r] = n_new;
      ntiles += n_new;
      for (int64_t k = 0; k < ncls; ++k) {
        int64_t left = c[k] - take[r * ncls + k];
        int64_t in_last = left - (n_new - 1) * cap;
        room[k] = cap - std::max<int64_t>(in_last, 0);
      }
      have_room = true;
      open_w = w;
    }
  }
  if (cur_b >= 0) tot_tiles[cur_b] = ntiles;
}

// Multi-open-tile dgt walk (kernels/dgt_gather._dgt_walk_multi): every tile
// with free room stays open while its window base is within nw reach, so
// later windows' overflow classes top up earlier tiles.  Emits (run, cls,
// tile, fill, cnt, sel) segments consumed in rank order per (run, cls),
// plus per-fresh-tile window bases.  Returns 0
// on success, 1 if seg_cap/wins_cap would overflow (the caller raises).
extern "C" int64_t ts_dgt_runs_multi(
    const int64_t* run_b, const int64_t* run_win, const int64_t* cnt,
    int64_t n_runs, int64_t ncls, int64_t cap, int64_t nw, int64_t n_buckets,
    int64_t max_open, int64_t seg_cap,
    int64_t* seg_run, int64_t* seg_cls, int64_t* seg_tile, int64_t* seg_fill,
    int64_t* seg_cnt, int64_t* seg_sel,
    int64_t* wins_b, int64_t* wins_t, int64_t* wins_w,
    int64_t* tot_tiles, int64_t* counts) {
  (void)n_buckets;
  struct Open {
    int64_t base_w, tile;
    std::vector<int64_t> room;
  };
  std::vector<Open> opens;
  std::vector<int64_t> left(ncls);
  int64_t cur_b = -1, ntiles = 0, ns = 0, nwn = 0;
  for (int64_t r = 0; r < n_runs; ++r) {
    int64_t b = run_b[r];
    int64_t w = run_win[r];
    if (b != cur_b) {
      if (cur_b >= 0) tot_tiles[cur_b] = ntiles;
      cur_b = b;
      ntiles = 0;
      opens.clear();
    }
    int64_t left_any = 0;
    for (int64_t k = 0; k < ncls; ++k) {
      left[k] = cnt[r * ncls + k];
      left_any += left[k];
    }
    // drop unreachable / full tiles
    size_t kept = 0;
    for (size_t i = 0; i < opens.size(); ++i) {
      int64_t rs = 0;
      for (int64_t k = 0; k < ncls; ++k) rs += opens[i].room[k];
      if (opens[i].base_w > w - nw && rs > 0) opens[kept++] = opens[i];
    }
    opens.resize(kept);
    for (auto& o : opens) {
      if (!left_any) break;
      for (int64_t k = 0; k < ncls; ++k) {
        int64_t t = std::min(o.room[k], left[k]);
        if (t <= 0) continue;
        if (ns >= seg_cap) return 1;
        seg_run[ns] = r;
        seg_cls[ns] = k;
        seg_tile[ns] = o.tile;
        seg_fill[ns] = cap - o.room[k];
        seg_cnt[ns] = t;
        seg_sel[ns] = w - o.base_w;
        ++ns;
        o.room[k] -= t;
        left[k] -= t;
        left_any -= t;
      }
    }
    int64_t lmax = 0;
    for (int64_t k = 0; k < ncls; ++k) lmax = std::max(lmax, left[k]);
    if (lmax > 0) {
      int64_t n_new = (lmax + cap - 1) / cap;
      for (int64_t j = 0; j < n_new; ++j) {
        Open o;
        o.base_w = w;
        o.tile = ntiles + j;
        o.room.assign(ncls, cap);
        for (int64_t k = 0; k < ncls; ++k) {
          int64_t take_c = std::min(cap, std::max<int64_t>(left[k] - j * cap, 0));
          if (take_c > 0) {
            if (ns >= seg_cap) return 1;
            seg_run[ns] = r;
            seg_cls[ns] = k;
            seg_tile[ns] = o.tile;
            seg_fill[ns] = 0;
            seg_cnt[ns] = take_c;
            seg_sel[ns] = 0;
            ++ns;
            o.room[k] = cap - take_c;
          }
        }
        opens.push_back(std::move(o));
        if (nwn >= seg_cap) return 1;
        wins_b[nwn] = b;
        wins_t[nwn] = ntiles + j;
        wins_w[nwn] = w;
        ++nwn;
      }
      ntiles += n_new;
      if ((int64_t)opens.size() > max_open)
        opens.erase(opens.begin(), opens.end() - max_open);
    }
  }
  if (cur_b >= 0) tot_tiles[cur_b] = ntiles;
  counts[0] = ns;
  counts[1] = nwn;
  return 0;
}

}  // extern "C"
