// Native runtime for jn_cuclark_tpu: FASTA/FASTQ scanning, 2-bit batch
// packing, and C-printf CSV result formatting.
//
// Counterpart of the reference's host-side engine hot loops
// (CuCLARK_hh.hh:1340-1534 read scan, :1610-1726 container packing,
// :1946-2122 result printing), redesigned for the packed [R, stride] row
// layout consumed by the JAX device pipeline instead of the CUDA container
// stream.  Exposed with a C ABI for ctypes; all buffers are numpy-owned.
//
// Built at first use by jn_cuclark_tpu/utils/native.py
// (g++ -O3 -march=native -fPIC -fopenmp -shared).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <locale.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Worker threads the parallel loops below use (1 in a serial build).
int native_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// ---------------------------------------------------------------- scanning
//
// scan_fasta/scan_fastq fill per-read arrays:
//   name_start/name_end : byte offsets of the object name (reference quirk:
//                         the separator scan starts at the SECOND name char)
//   seq_start/seq_end   : byte span of the read's sequence region (FASTA:
//                         from after the header newline to the next '>'
//                         line or EOF, newlines included; FASTQ: line 2)
//   length              : number of sequence chars (newlines excluded)
// Returns number of reads (capped at cap), or -1 on malformed input.

static inline bool is_sep(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n';
}

// SIMD newline scan (glibc memchr): ~5x the byte loop on long lines
static inline int64_t next_nl(const uint8_t* d, int64_t n, int64_t i) {
  if (i >= n) return n;
  const void* p = memchr(d + i, '\n', (size_t)(n - i));
  return p ? (const uint8_t*)p - d : n;
}

int64_t scan_fasta(const uint8_t* d, int64_t n, int64_t cap,
                   int64_t* name_start, int64_t* name_end,
                   int64_t* seq_start, int64_t* seq_end, int64_t* length) {
  int64_t r = -1;
  int64_t i = 0;
  bool at_line_start = true;
  while (i < n) {
    if (at_line_start && d[i] == '>') {
      if (r + 1 >= cap) return -2;  // caller must grow
      ++r;
      name_start[r] = i + 1;
      int64_t j = i + 2;  // reference pre-increments: first char always kept
      while (j < n && !is_sep(d[j])) ++j;
      name_end[r] = j < n ? j : n;
      i = next_nl(d, n, i);
      ++i;
      seq_start[r] = i;
      seq_end[r] = i;
      length[r] = 0;
      at_line_start = true;
      continue;
    }
    // sequence line for current record
    int64_t ls = i;
    i = next_nl(d, n, i);
    if (r >= 0) {
      length[r] += i - ls;
      seq_end[r] = i;
    }
    ++i;
    at_line_start = true;
  }
  return r + 1;
}

int64_t scan_fastq(const uint8_t* d, int64_t n, int64_t cap,
                   int64_t* name_start, int64_t* name_end,
                   int64_t* seq_start, int64_t* seq_end, int64_t* length) {
  int64_t r = 0;
  int64_t i = 0;
  while (i < n) {
    if (r >= cap) return -2;
    // line 1: header
    name_start[r] = i + 1;
    int64_t j = i + 2;
    while (j < n && !is_sep(d[j])) ++j;
    name_end[r] = j < n ? j : n;
    i = next_nl(d, n, i);
    ++i;
    if (i >= n) break;
    // line 2: sequence
    seq_start[r] = i;
    i = next_nl(d, n, i);
    seq_end[r] = i;
    length[r] = seq_end[r] - seq_start[r];
    ++i;
    // line 3 + 4
    i = next_nl(d, n, i);
    ++i;
    i = next_nl(d, n, i);
    ++i;
    ++r;
  }
  return r;
}

// ---------------------------------------------------------------- packing
//
// pack_batch packs reads [0, nreads) (described by seq spans into d) into
// [R, stride/32 + 1] uint64 code words and [R, stride/64 + 1] uint64
// validity words, first char in the lowest bits.  code: A=0 C=1 G=2 T=3
// (U=T), case-insensitive; anything else (and padding) is invalid.

static int8_t CODE[256];
static bool code_init_done = false;

static void code_init() {
  if (code_init_done) return;
  for (int i = 0; i < 256; i++) CODE[i] = -1;
  CODE['A'] = CODE['a'] = 0;
  CODE['C'] = CODE['c'] = 1;
  CODE['G'] = CODE['g'] = 2;
  CODE['T'] = CODE['t'] = 3;
  CODE['U'] = CODE['u'] = 3;
  code_init_done = true;
}

void pack_batch(const uint8_t* d, int64_t nreads,
                const int64_t* seq_start, const int64_t* seq_end,
                int64_t stride, uint64_t* words, uint64_t* vwords) {
  code_init();
  const int64_t W = stride / 32 + 1;
  const int64_t WV = stride / 64 + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t r = 0; r < nreads; r++) {
    uint64_t* wrow = words + r * W;
    uint64_t* vrow = vwords + r * WV;
    memset(wrow, 0, W * sizeof(uint64_t));
    memset(vrow, 0, WV * sizeof(uint64_t));
    int64_t pos = 0;  // char position within the row
    for (int64_t i = seq_start[r]; i < seq_end[r] && pos < stride; i++) {
      uint8_t c = d[i];
      if (c == '\n') continue;
      int8_t code = CODE[c];
      if (code >= 0) {
        wrow[pos >> 5] |= (uint64_t)code << ((pos & 31) * 2);
        vrow[pos >> 6] |= 1ull << (pos & 63);
      }
      ++pos;
    }
  }
}

// ------------------------------------------------------------- CSV output
//
// format_rows renders classification rows exactly like
// printExtendedResultsSynced (CuCLARK_hh.hh:2096-2118):
//   fprintf("%s,%g,%s,%u,%g\n", name, gamma, targetName, best, conf)
// names: raw file buffer + per-read offsets (truncated to 39 chars);
// target_names: concatenated NUL-separated strings indexed by offsets.
// Returns bytes written to out (caller sizes out generously), or -1 if out
// would overflow.

static int64_t format_rows_range(const uint8_t* data,
                                 const int64_t* name_start,
                                 const int64_t* name_end,
                                 const int32_t* total, const int32_t* ibest,
                                 const int32_t* best, const int32_t* sbest,
                                 const int64_t* norm, int64_t r0, int64_t r1,
                                 int32_t k, const char* tn_buf,
                                 const int64_t* tn_off, char* out,
                                 int64_t out_cap) {
  int64_t w = 0;
  char name[64];
  for (int64_t r = r0; r < r1; r++) {
    int64_t ns = name_start[r], ne = name_end[r];
    int64_t len = ne - ns;
    if (len > 39) len = 39;
    memcpy(name, data + ns, len);
    name[len] = '\0';
    double gamma = (double)total[r] / ((double)norm[r] - k + 1.0);
    double delta = (double)(best[r] + sbest[r]);
    double conf = (delta < 0.001) ? 0.0 : (double)best[r] / delta;
    const char* tname = tn_buf + tn_off[ibest[r]];
    if (out_cap - w < 256) return -1;
    int64_t m = snprintf(out + w, out_cap - w, "%s,%g,%s,%u,%g\n", name, gamma,
                         tname, (unsigned)best[r], conf);
    if (m >= out_cap - w) return -1;  // snprintf truncated this row
    w += m;
  }
  return w;
}

int64_t format_rows(const uint8_t* data,
                    const int64_t* name_start, const int64_t* name_end,
                    const int32_t* total, const int32_t* ibest,
                    const int32_t* best, const int32_t* sbest,
                    const int64_t* norm, int64_t nreads, int32_t k,
                    const char* tn_buf, const int64_t* tn_off,
                    char* out, int64_t out_cap) {
#ifdef _OPENMP
  // snprintf dominates the host format stage (~40 ms per 43k-read batch
  // single-threaded); rows are independent, so format chunks into
  // per-thread scratch and gather — the gather memcpy is ~10 GB/s
  int nt = omp_get_max_threads();
  if (nreads >= 8192 && nt > 1) {
    if (nt > 8) nt = 8;
    int64_t chunk = (nreads + nt - 1) / nt;
    int64_t scratch_cap = chunk * 256 + 64;
    char* scratch = (char*)malloc((size_t)(scratch_cap * nt));
    if (scratch) {
      int64_t lens[8];
#pragma omp parallel for num_threads(nt) schedule(static, 1)
      for (int t = 0; t < nt; t++) {
        int64_t r0 = t * chunk;
        int64_t r1 = r0 + chunk < nreads ? r0 + chunk : nreads;
        lens[t] = r0 >= r1 ? 0
                           : format_rows_range(
                                 data, name_start, name_end, total, ibest,
                                 best, sbest, norm, r0, r1, k, tn_buf,
                                 tn_off, scratch + t * scratch_cap,
                                 scratch_cap);
      }
      int64_t w = 0;
      for (int t = 0; t < nt; t++) {
        if (lens[t] < 0 || w + lens[t] > out_cap) {
          free(scratch);
          return -1;
        }
        memcpy(out + w, scratch + t * scratch_cap, (size_t)lens[t]);
        w += lens[t];
      }
      free(scratch);
      return w;
    }
  }
#endif
  return format_rows_range(data, name_start, name_end, total, ibest, best,
                           sbest, norm, 0, nreads, k, tn_buf, tn_off, out,
                           out_cap);
}

// extended rows: per-target scores inserted after the name
static int64_t format_rows_extended_range(
    const uint8_t* data, const int64_t* name_start, const int64_t* name_end,
    const int32_t* counts, const int32_t* total, const int32_t* ibest,
    const int32_t* best, const int32_t* sbest, const int64_t* norm,
    int64_t r0, int64_t r1, int32_t ntargets, int32_t k, const char* tn_buf,
    const int64_t* tn_off, char* out, int64_t out_cap) {
  int64_t w = 0;
  char name[64];
  for (int64_t r = r0; r < r1; r++) {
    int64_t ns = name_start[r], ne = name_end[r];
    int64_t len = ne - ns;
    if (len > 39) len = 39;
    memcpy(name, data + ns, len);
    name[len] = '\0';
    if (out_cap - w < 64 + 12ll * ntargets) return -1;
    int64_t m = snprintf(out + w, out_cap - w, "%s", name);
    if (m >= out_cap - w) return -1;
    w += m;
    const int32_t* row = counts + r * (int64_t)(ntargets + 1);
    for (int32_t t = 1; t <= ntargets; t++) {
      m = snprintf(out + w, out_cap - w, ",%d", row[t]);
      if (m >= out_cap - w) return -1;
      w += m;
    }
    double gamma = (double)total[r] / ((double)norm[r] - k + 1.0);
    double delta = (double)(best[r] + sbest[r]);
    double conf = (delta < 0.001) ? 0.0 : (double)best[r] / delta;
    const char* tname = tn_buf + tn_off[ibest[r]];
    m = snprintf(out + w, out_cap - w, ",%g,%s,%u,%g\n", gamma, tname,
                 (unsigned)best[r], conf);
    if (m >= out_cap - w) return -1;
    w += m;
  }
  return w;
}

int64_t format_rows_extended(const uint8_t* data,
                             const int64_t* name_start, const int64_t* name_end,
                             const int32_t* counts,  // [nreads, ntargets+1]
                             const int32_t* total, const int32_t* ibest,
                             const int32_t* best, const int32_t* sbest,
                             const int64_t* norm, int64_t nreads,
                             int32_t ntargets, int32_t k,
                             const char* tn_buf, const int64_t* tn_off,
                             char* out, int64_t out_cap) {
#ifdef _OPENMP
  // same two-phase split as format_rows — extended rows are ~12*ntargets
  // bytes of snprintf each, so this stage binds even sooner
  int nt = omp_get_max_threads();
  if (nreads >= 2048 && nt > 1) {
    if (nt > 8) nt = 8;
    int64_t chunk = (nreads + nt - 1) / nt;
    int64_t scratch_cap = chunk * (192 + 12ll * ntargets) + 64;
    char* scratch = (char*)malloc((size_t)(scratch_cap * nt));
    if (scratch) {
      int64_t lens[8];
#pragma omp parallel for num_threads(nt) schedule(static, 1)
      for (int t = 0; t < nt; t++) {
        int64_t r0 = t * chunk;
        int64_t r1 = r0 + chunk < nreads ? r0 + chunk : nreads;
        lens[t] = r0 >= r1 ? 0
                           : format_rows_extended_range(
                                 data, name_start, name_end, counts, total,
                                 ibest, best, sbest, norm, r0, r1, ntargets,
                                 k, tn_buf, tn_off, scratch + t * scratch_cap,
                                 scratch_cap);
      }
      int64_t w = 0;
      for (int t = 0; t < nt; t++) {
        if (lens[t] < 0 || w + lens[t] > out_cap) {
          free(scratch);
          return -1;
        }
        memcpy(out + w, scratch + t * scratch_cap, (size_t)lens[t]);
        w += lens[t];
      }
      free(scratch);
      return w;
    }
  }
#endif
  return format_rows_extended_range(data, name_start, name_end, counts,
                                    total, ibest, best, sbest, norm, 0,
                                    nreads, ntargets, k, tn_buf, tn_off, out,
                                    out_cap);
}

// format_rows_extended_sorted: extended CSV from each read's SORTED
// per-window label row (label+1 ascending, 0 = miss/padding) instead of a
// dense [nreads, ntargets+1] count matrix.  The device already sorts the
// row for the top-2 scoring (score.top2_from_labels), so extended mode can
// ship 2*width bytes/read and stay O(windows) on device regardless of the
// target count; runs expand to per-target counts here while the CSV is
// written (one linear merge of the sorted row against t = 1..ntargets).
static int64_t format_rows_extended_sorted_range(
    const uint8_t* data, const int64_t* name_start, const int64_t* name_end,
    const uint16_t* sorted_lab, int64_t width, const int32_t* total,
    const int32_t* ibest, const int32_t* best, const int32_t* sbest,
    const int64_t* norm, int64_t r0, int64_t r1, int32_t ntargets, int32_t k,
    const char* tn_buf, const int64_t* tn_off, char* out, int64_t out_cap) {
  int64_t w = 0;
  char name[64];
  for (int64_t r = r0; r < r1; r++) {
    int64_t ns = name_start[r], ne = name_end[r];
    int64_t len = ne - ns;
    if (len > 39) len = 39;
    memcpy(name, data + ns, len);
    name[len] = '\0';
    if (out_cap - w < 64 + 12ll * ntargets) return -1;
    int64_t m = snprintf(out + w, out_cap - w, "%s", name);
    if (m >= out_cap - w) return -1;
    w += m;
    const uint16_t* row = sorted_lab + r * width;
    int64_t j = 0;
    while (j < width && row[j] == 0) j++;  // leading misses/padding
    for (int32_t t = 1; t <= ntargets; t++) {
      int32_t cnt = 0;
      while (j < width && row[j] == (uint16_t)t) { cnt++; j++; }
      m = snprintf(out + w, out_cap - w, ",%d", cnt);
      if (m >= out_cap - w) return -1;
      w += m;
    }
    double gamma = (double)total[r] / ((double)norm[r] - k + 1.0);
    double delta = (double)(best[r] + sbest[r]);
    double conf = (delta < 0.001) ? 0.0 : (double)best[r] / delta;
    const char* tname = tn_buf + tn_off[ibest[r]];
    m = snprintf(out + w, out_cap - w, ",%g,%s,%u,%g\n", gamma, tname,
                 (unsigned)best[r], conf);
    if (m >= out_cap - w) return -1;
    w += m;
  }
  return w;
}

int64_t format_rows_extended_sorted(
    const uint8_t* data, const int64_t* name_start, const int64_t* name_end,
    const uint16_t* sorted_lab,  // [nreads, width], ascending per row
    int64_t width, const int32_t* total, const int32_t* ibest,
    const int32_t* best, const int32_t* sbest, const int64_t* norm,
    int64_t nreads, int32_t ntargets, int32_t k, const char* tn_buf,
    const int64_t* tn_off, char* out, int64_t out_cap) {
#ifdef _OPENMP
  int nt = omp_get_max_threads();
  if (nreads >= 2048 && nt > 1) {
    if (nt > 8) nt = 8;
    int64_t chunk = (nreads + nt - 1) / nt;
    int64_t scratch_cap = chunk * (192 + 12ll * ntargets) + 64;
    char* scratch = (char*)malloc((size_t)(scratch_cap * nt));
    if (scratch) {
      int64_t lens[8];
#pragma omp parallel for num_threads(nt) schedule(static, 1)
      for (int t = 0; t < nt; t++) {
        int64_t r0 = t * chunk;
        int64_t r1 = r0 + chunk < nreads ? r0 + chunk : nreads;
        lens[t] = r0 >= r1 ? 0
                           : format_rows_extended_sorted_range(
                                 data, name_start, name_end, sorted_lab,
                                 width, total, ibest, best, sbest, norm, r0,
                                 r1, ntargets, k, tn_buf, tn_off,
                                 scratch + t * scratch_cap, scratch_cap);
      }
      int64_t w = 0;
      for (int t = 0; t < nt; t++) {
        if (lens[t] < 0 || w + lens[t] > out_cap) {
          free(scratch);
          return -1;
        }
        memcpy(out + w, scratch + t * scratch_cap, (size_t)lens[t]);
        w += lens[t];
      }
      free(scratch);
      return w;
    }
  }
#endif
  return format_rows_extended_sorted_range(
      data, name_start, name_end, sorted_lab, width, total, ibest, best,
      sbest, norm, 0, nreads, ntargets, k, tn_buf, tn_off, out, out_cap);
}

// ------------------------------------------------------- paired-end merge
//
// Chunked equivalent of the reference's mergePairedFiles (file.cc:205-268):
// both FASTQ files advance line-by-line in lockstep; whenever line i of both
// starts with '@', the first name token (separators " /\t@") must match and
// the record becomes ">name\nseq1" "N" "seq2\n"; otherwise both advance one
// line.  Processes whole records while they fit in out; *p1/*p2 are byte
// offsets of the current line and are updated so the caller can stream a
// multi-GB merge through a bounded buffer.
// status: 0 = reached EOF, 1 = out full (call again), -1 = read-id mismatch,
//         -2 = a single record exceeds cap (caller grows).

static inline bool is_merge_sep(uint8_t c) {
  return c == ' ' || c == '/' || c == '\t' || c == '@';
}

// [start, end) of the line beginning at p (end excludes '\n')
static inline int64_t line_end(const uint8_t* d, int64_t n, int64_t p) {
  return next_nl(d, n, p);
}

int64_t merge_paired_chunk(const uint8_t* d1, int64_t n1,
                           const uint8_t* d2, int64_t n2,
                           int64_t* p1, int64_t* p2,
                           uint8_t* out, int64_t cap, int32_t* status) {
  int64_t i1 = *p1, i2 = *p2;
  int64_t w = 0;
  *status = 0;
  while (i1 < n1 && i2 < n2) {
    int64_t e1 = line_end(d1, n1, i1);
    int64_t e2 = line_end(d2, n2, i2);
    // "i + 1 < n": a next line must exist in both files
    if (e1 >= n1 || e2 >= n2) break;
    if (i1 < e1 && i2 < e2 && d1[i1] == '@' && d2[i2] == '@') {
      // first token of each header
      int64_t t1s = i1;
      while (t1s < e1 && is_merge_sep(d1[t1s])) ++t1s;
      int64_t t1e = t1s;
      while (t1e < e1 && !is_merge_sep(d1[t1e])) ++t1e;
      int64_t t2s = i2;
      while (t2s < e2 && is_merge_sep(d2[t2s])) ++t2s;
      int64_t t2e = t2s;
      while (t2e < e2 && !is_merge_sep(d2[t2e])) ++t2e;
      if (t1e - t1s != t2e - t2s ||
          memcmp(d1 + t1s, d2 + t2s, t1e - t1s) != 0) {
        *status = -1;
        *p1 = i1;
        *p2 = i2;
        return w;
      }
      int64_t s1s = e1 + 1, s1e = line_end(d1, n1, s1s);
      int64_t s2s = e2 + 1, s2e = line_end(d2, n2, s2s);
      int64_t need = 2 + (t1e - t1s) + (s1e - s1s) + 1 + (s2e - s2s) + 1;
      if (w + need > cap) {
        *status = (w == 0) ? -2 : 1;
        *p1 = i1;
        *p2 = i2;
        return w;
      }
      out[w++] = '>';
      memcpy(out + w, d1 + t1s, t1e - t1s);
      w += t1e - t1s;
      out[w++] = '\n';
      memcpy(out + w, d1 + s1s, s1e - s1s);
      w += s1e - s1s;
      out[w++] = 'N';
      memcpy(out + w, d2 + s2s, s2e - s2s);
      w += s2e - s2s;
      out[w++] = '\n';
      // advance 4 lines in both files
      i1 = s1e + 1;
      for (int t = 0; t < 2 && i1 <= n1; t++) i1 = line_end(d1, n1, i1) + 1;
      i2 = s2e + 1;
      for (int t = 0; t < 2 && i2 <= n2; t++) i2 = line_end(d2, n2, i2) + 1;
    } else {
      i1 = e1 + 1;
      i2 = e2 + 1;
    }
  }
  *p1 = i1;
  *p2 = i2;
  return w;
}

}  // extern "C"

// ----------------------------------------------------------- DB construction
//
// Native equivalents of the reference's build hot path (the streaming k-mer
// scan of makeSpecificTargetSets, CuCLARK_hh.hh:691-1329, and the chained
// hash-table aggregation) recast as extract -> parallel sort -> linear scan.

#include <algorithm>
#include <vector>
#if defined(_OPENMP)
#include <parallel/algorithm>
#define PSORT __gnu_parallel::stable_sort
#else
#define PSORT std::stable_sort
#endif

extern "C" {

// Rolling canonical k-mer extraction from a FASTA/FASTQ byte buffer.
//   fwd' = (fwd >> 2) | code << 2(k-1)        (enc_le append)
//   rc'  = ((rc << 2) | (3 - code)) & mask    (enc_le of revcomp)
//   canonical = min(fwd, rc)
// light mode: non-overlapping k-mers, per-file counter picks every gap-th.
// Returns the number of canonical values written, or -1 on bad format.
int64_t extract_canonical(const uint8_t* d, int64_t n, int32_t k,
                          int32_t light, int64_t gap, uint64_t* out) {
  code_init();
  if (n == 0) return 0;
  const int fasta = d[0] == '>';
  const int fastq = d[0] == '@';
  if (!fasta && !fastq) return -1;
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
  const int shift_hi = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int32_t cpt = 0;
  int64_t iter = 0;
  int64_t w = 0;
  int64_t i = 0;
  int line = 0;  // fastq line index within record
  while (i < n) {
    uint8_t ch = d[i];
    if (fasta && ch == '>') {
      while (i < n && d[i] != '\n') ++i;
      ++i;
      fwd = rc = 0;
      cpt = 0;
      continue;
    }
    if (ch == '\n') {
      ++i;
      if (fastq) {
        line = (line + 1) & 3;
        if (line != 1) {  // only line 1 of each record is sequence
          fwd = rc = 0;
          cpt = 0;
          // skip to next newline fast for non-seq lines
          if (line == 0 || line == 2 || line == 3) continue;
        }
      }
      continue;
    }
    if (fastq && line != 1) { ++i; continue; }
    int8_t code = CODE[ch];
    if (code < 0) {
      fwd = rc = 0;
      cpt = 0;
      ++i;
      continue;
    }
    if (light) {
      rc = ((rc << 2) | (uint64_t)(3 - code)) & mask;
      fwd = (fwd >> 2) | ((uint64_t)code << shift_hi);
      if (++cpt == k) {
        if (iter % gap == 0) out[w++] = fwd < rc ? fwd : rc;
        ++iter;
        fwd = rc = 0;
        cpt = 0;
      }
    } else {
      rc = ((rc << 2) | (uint64_t)(3 - code)) & mask;
      fwd = (fwd >> 2) | ((uint64_t)code << shift_hi);
      if (cpt < k - 1) {
        ++cpt;
      } else {
        out[w++] = fwd < rc ? fwd : rc;
      }
    }
    ++i;
  }
  return w;
}

// Parallel stable argsort of uint64 keys.  Sorts (key, index) PAIRS so
// comparisons are cache-local (indirect index sorts are ~3x slower).
struct KV {
  uint64_t k;
  int64_t v;
};

void argsort_u64(const uint64_t* keys, int64_t n, int64_t* idx) {
  std::vector<KV> kv(n);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int64_t i = 0; i < n; i++) kv[i] = {keys[i], i};
  PSORT(kv.begin(), kv.end(),
        [](const KV& a, const KV& b) { return a.k < b.k; });
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int64_t i = 0; i < n; i++) idx[i] = kv[i].v;
}

// Aggregate pre-extracted occurrences (canon, label) in stream order into
// distinct k-mers with the reference's multiplicity/count rules (counts all
// 1, i.e. sequence inputs).  pg[label] = prefix-group id.
// Outputs sized n (caller trims to return value).
// Emit pass shared by the one-shot and the partitioned aggregates: kv is
// sorted by (canonical, payload); payload = stream_index<<16 | label.
static int64_t aggregate_emit(const KV* kv, int64_t n, const int32_t* pg,
                              int32_t lelement, uint64_t* out_canon,
                              int32_t* out_label, int32_t* out_mult,
                              int64_t* out_count, int64_t* out_first_seq) {
  int64_t ng = -1;
  uint64_t cur = 0;
  int32_t l0 = 0, pg0 = 0;
  for (int64_t t = 0; t < n; t++) {
    int64_t i = kv[t].v >> 16;
    uint64_t c = kv[t].k;
    int32_t l = (int32_t)(uint16_t)(kv[t].v & 0xffff);
    if (ng < 0 || c != cur) {
      ++ng;
      cur = c;
      l0 = l;
      pg0 = pg[l];
      out_canon[ng] = c;
      out_label[ng] = l;
      out_mult[ng] = 1;
      out_count[ng] = 1;
      out_first_seq[ng] = i;
    } else {
      int32_t d = (l != l0) + (pg[l] != pg0);
      int32_t m = out_mult[ng] + d;
      out_mult[ng] = m > 255 ? 255 : m;
      if (lelement) {
        if (out_count[ng] < 254) out_count[ng]++;
      } else {
        out_count[ng]++;
      }
    }
  }
  return ng + 1;
}

int64_t aggregate_occurrences(const uint64_t* canon, const int32_t* label,
                              int64_t n, const int32_t* pg, int32_t lelement,
                              uint64_t* out_canon, int32_t* out_label,
                              int32_t* out_mult, int64_t* out_count,
                              int64_t* out_first_seq) {
  // sort (canonical, stream_index<<16 | label) pairs: the payload carries
  // BOTH the label and the stream index, so the emit pass reads kv
  // sequentially instead of gathering canon[i]/label[i] through a
  // permutation (the gathers were ~1/3 of the aggregate wall at 250M
  // occurrences).  Comparing the payload on equal keys reproduces the
  // stable stream order exactly (stream indices are distinct).  Labels
  // must fit 16 bits (MTRGTS <= 65535, dataType.hh:46 — enforced by
  // build_database before calling in) and indices 48.
  std::vector<KV> kv(n);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int64_t i = 0; i < n; i++)
    kv[i] = {canon[i], (i << 16) | (int64_t)(uint16_t)label[i]};
  PSORT(kv.begin(), kv.end(), [](const KV& a, const KV& b) {
    return a.k < b.k || (a.k == b.k && a.v < b.v);
  });
  return aggregate_emit(kv.data(), n, pg, lelement, out_canon, out_label,
                        out_mult, out_count, out_first_seq);
}

// ----------------- bounded-memory partitioned build (host-RAM ceiling)
//
// The one-shot aggregate+serialize peaks tens of GB at RefSeq scale (full
// kv vector + the parallel stable sort's full-size temp + n-sized output
// arrays all live at once).  The partitioned flow bounds the peak: the
// occurrence stream scatters into ONE (canon, payload) buffer bucketed by
// canonical range (ranges keep the aggregate's global canonical-ascending
// output order), then each partition sorts/aggregates/filters
// independently — sort temp and output arrays are one partition's size.
// The reference's chained hash table builds in bounded memory too
// (hashTable_hh.hh:239-269); this is the sort-based equivalent.

// Pass 1: occurrences per canonical-range partition (pid = canon >> shift).
void occ_partition_count(const uint64_t* canon, int64_t n, int32_t shift,
                         int64_t* counts) {
  for (int64_t i = 0; i < n; i++) counts[canon[i] >> shift]++;
}

// Pass 2: scatter one file's occurrences (constant label) into the
// partition buffer; cursors advance.  payload = (global index << 16) | label.
void occ_partition_scatter(const uint64_t* canon, int64_t n, int32_t label,
                           int64_t base_index, int32_t shift,
                           int64_t* cursors, KV* kv) {
  const int64_t lab = (int64_t)(uint16_t)label;
  for (int64_t i = 0; i < n; i++) {
    int64_t pid = (int64_t)(canon[i] >> shift);
    kv[cursors[pid]++] = {canon[i], ((base_index + i) << 16) | lab};
  }
}

// Sort + aggregate ONE partition of the kv buffer in place.
int64_t aggregate_kv_range(KV* kv, int64_t n, const int32_t* pg,
                           int32_t lelement, uint64_t* out_canon,
                           int32_t* out_label, int32_t* out_mult,
                           int64_t* out_count, int64_t* out_first_seq) {
  PSORT(kv, kv + n, [](const KV& a, const KV& b) {
    return a.k < b.k || (a.k == b.k && a.v < b.v);
  });
  return aggregate_emit(kv, n, pg, lelement, out_canon, out_label,
                        out_mult, out_count, out_first_seq);
}

// ------------------------------------------------------- abundance scan
//
// One pass over a classification-CSV body (header already consumed by the
// caller), replicating getAbundance.cc's per-line filter (via the Python
// reference semantics in abundance.estimate): fields are non-empty runs
// between [,\t\r\n]; a line with no fields is skipped; the assignment label
// is field[idx], demoted to "NA" when the line has >3 fields and
// float(field[idx-1]) < min_gamma or float(field[idx+2]) < min_conf (or
// either fails to parse / is missing).  Labels are returned as uint64 keys
// (label bytes, little-endian, zero-padded); missing-label lines get the
// key for "NA".  Returns the number of counted lines, or -1 when a label
// exceeds 8 bytes or contains NUL (caller falls back to the Python path).

static const uint64_t NA_KEY = (uint64_t)'N' | ((uint64_t)'A' << 8);

// Python float() semantics for a CSV field, or bail.  Returns 1 on a
// parsed float, 0 on a field Python would also reject (ValueError), and -1
// on anything whose Python result strtod cannot be trusted to reproduce
// (very long numerals, '_' digit separators, non-ASCII digits, hex) — the
// caller then falls back to the Python path for the whole file.
static int parse_float_field(const uint8_t* s, int64_t len, double* out) {
  char buf[64];
  if (len <= 0) return 0;
  if (len >= (int64_t)sizeof(buf)) return -1;
  for (int64_t i = 0; i < len; i++) {
    if (s[i] == 'x' || s[i] == 'X' || s[i] == '_' || s[i] >= 0x80) return -1;
    if (s[i] == '\0') return -1;
  }
  memcpy(buf, s, (size_t)len);
  buf[len] = '\0';
  char* end = nullptr;
  // strtod is LC_NUMERIC-sensitive; pin the C locale so an embedding app's
  // setlocale() cannot change how "0.5" parses
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  double v = c_loc ? strtod_l(buf, &end, c_loc) : strtod(buf, &end);
  if (end == buf) return 0;
  while (*end && isspace((unsigned char)*end)) ++end;  // Python strips ws
  if (*end != '\0') return 0;
  *out = v;
  return 1;
}

int64_t abundance_scan(const uint8_t* d, int64_t n, int64_t idx,
                       double min_gamma, double min_conf, uint64_t* keys) {
  if (idx < 2) return -1;  // negative-index header quirk: Python path
  int64_t total = 0;
  int64_t i = 0;
  while (i < n) {
    // scan one line: record spans of fields idx-1, idx, idx+2
    int64_t nf = 0;
    int64_t g0 = -1, g1 = -1, l0 = -1, l1 = -1, c0 = -1, c1 = -1;
    while (i < n && d[i] != '\n' && d[i] != '\r') {
      if (d[i] == ',' || d[i] == '\t') {
        ++i;
        continue;
      }
      int64_t f0 = i;
      while (i < n && d[i] != ',' && d[i] != '\t' && d[i] != '\n' &&
             d[i] != '\r')
        ++i;
      if (nf == idx - 1) { g0 = f0; g1 = i; }
      else if (nf == idx) { l0 = f0; l1 = i; }
      else if (nf == idx + 2) { c0 = f0; c1 = i; }
      ++nf;
    }
    if (i < n) ++i;  // consume the line break
    if (nf == 0) continue;
    uint64_t key;
    if (l0 < 0) {
      key = NA_KEY;  // idx >= nfields -> "NA"
    } else {
      int64_t len = l1 - l0;
      if (len > 8) return -1;
      key = 0;
      for (int64_t j = 0; j < len; j++) {
        if (d[l0 + j] == '\0') return -1;
        key |= (uint64_t)d[l0 + j] << (8 * j);
      }
    }
    if (nf > 3) {
      double g = 0, c = 0;
      bool ok = false;
      if (g0 >= 0 && c0 >= 0) {
        int rg = parse_float_field(d + g0, g1 - g0, &g);
        if (rg < 0) return -1;  // Python path decides
        if (rg > 0) {
          int rc = parse_float_field(d + c0, c1 - c0, &c);
          if (rc < 0) return -1;
          ok = rc > 0 && g >= min_gamma && c >= min_conf;
        }
      }
      if (!ok) key = NA_KEY;
    }
    keys[total++] = key;
  }
  return total;
}

// Fused DB serialization (hashTable_hh.hh:473-546 layout): from DISTINCT
// (canonical, label) pairs, compute remainder/quotient vs HTSIZE, order
// bucket-major by remainder then by quotient within the bucket, and emit
// the .sz bucket-size bytes + .ky quotients (2/4/8-byte width) + .lb
// labels in one pass.  Replaces the numpy mod/div + composite pack +
// argsort + three gathers + RLE-scatter chain (~2.5x end-to-end on a
// 250M-key serialize; the .sz scatter becomes a sequential ascending
// write).  PSORT is a STABLE sort, so equal composites (duplicate
// canonical k-mers — possible only for callers outside the builder, whose
// aggregate guarantees distinctness) keep input order, matching the numpy
// stable-argsort path byte for byte.  Requires rem_bits + quotient bits
// <= 64 (k <= 31; the
// caller keeps the k == 32 lexsort fallback).  Returns 0, or -1 when a
// bucket exceeds 255 entries (the reference's hard format limit,
// hashTable_hh.hh:499-507).
struct KL {
  uint64_t k;
  uint16_t lab;
};

int32_t serialize_db(const uint64_t* canon, const uint16_t* labels,
                     int64_t n, uint64_t htsize, int32_t rem_bits,
                     int32_t key_bytes, uint8_t* sizes, uint8_t* out_keys,
                     uint16_t* out_lab) {
  std::vector<KL> kv(n);
  const int shift = 64 - rem_bits;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    uint64_t c = canon[i];
    uint64_t q = c / htsize;
    uint64_t r = c - q * htsize;
    kv[i].k = (r << shift) | q;
    kv[i].lab = labels[i];
  }
  PSORT(kv.begin(), kv.end(),
        [](const KL& a, const KL& b) { return a.k < b.k; });
  const uint64_t qmask = ((uint64_t)1 << shift) - 1;
  int64_t run = 0;
  uint64_t prev_r = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t r = kv[i].k >> shift;
    if (i == 0 || r != prev_r) {
      if (i > 0) {
        if (run > 255) return -1;
        sizes[prev_r] = (uint8_t)run;
      }
      prev_r = r;
      run = 0;
    }
    run++;
    uint64_t q = kv[i].k & qmask;
    out_lab[i] = kv[i].lab;
    switch (key_bytes) {
      case 2: ((uint16_t*)out_keys)[i] = (uint16_t)q; break;
      case 4: ((uint32_t*)out_keys)[i] = (uint32_t)q; break;
      default: ((uint64_t*)out_keys)[i] = q; break;
    }
  }
  if (n > 0) {
    if (run > 255) return -1;
    sizes[prev_r] = (uint8_t)run;
  }
  return 0;
}

// Partitioned serialize_db: buckets are partitioned by the TOP pbits of
// the remainder, so every bucket lives wholly inside one partition, each
// partition's entries are contiguous in the bucket-major output, and the
// stable sort's temp is one partition instead of the whole table (the
// one-shot path's parallel stable sort doubles the 16-byte-per-entry
// buffer at RefSeq scale).  Serial scatter + per-partition stable sort
// preserve input order for equal composites, so output stays
// byte-identical to serialize_db and the numpy path.
int32_t serialize_db_parts(const uint64_t* canon, const uint16_t* labels,
                           int64_t n, uint64_t htsize, int32_t rem_bits,
                           int32_t key_bytes, int32_t pbits, uint8_t* sizes,
                           uint8_t* out_keys, uint16_t* out_lab) {
  if (pbits <= 0 || pbits >= rem_bits)
    return serialize_db(canon, labels, n, htsize, rem_bits, key_bytes,
                        sizes, out_keys, out_lab);
  const int shift = 64 - rem_bits;
  const int64_t P = 1ll << pbits;
  const int pshift = rem_bits - pbits;  // partition id = remainder >> pshift
  std::vector<int64_t> counts((size_t)P, 0);
#ifdef _OPENMP
#pragma omp parallel
  {
    std::vector<int64_t> local((size_t)P, 0);
#pragma omp for nowait
    for (int64_t i = 0; i < n; i++) {
      uint64_t r = canon[i] % htsize;
      local[r >> pshift]++;
    }
#pragma omp critical
    for (int64_t p = 0; p < P; p++) counts[p] += local[p];
  }
#else
  for (int64_t i = 0; i < n; i++) counts[(canon[i] % htsize) >> pshift]++;
#endif
  std::vector<int64_t> offs((size_t)P + 1, 0);
  for (int64_t p = 0; p < P; p++) offs[p + 1] = offs[p] + counts[p];
  std::vector<KL> kl((size_t)n);
  std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
  for (int64_t i = 0; i < n; i++) {  // serial: keeps equal-key input order
    uint64_t c = canon[i];
    uint64_t q = c / htsize;
    uint64_t r = c - q * htsize;
    kl[cur[r >> pshift]++] = {(r << shift) | q, labels[i]};
  }
  const uint64_t qmask = ((uint64_t)1 << shift) - 1;
  // written concurrently (same value) from the partition loop; atomic write
  // keeps it a defined program rather than a benign-looking data race
  int overflow = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t p = 0; p < P; p++) {
    KL* a = kl.data() + offs[p];
    const int64_t m = counts[p];
    std::stable_sort(a, a + m,
                     [](const KL& x, const KL& y) { return x.k < y.k; });
    int64_t run = 0;
    uint64_t prev_r = 0;
    for (int64_t i = 0; i < m; i++) {
      uint64_t r = a[i].k >> shift;
      if (i == 0 || r != prev_r) {
        if (i > 0) {
          if (run > 255) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
            overflow = 1;
            break;
          }
          sizes[prev_r] = (uint8_t)run;
        }
        prev_r = r;
        run = 0;
      }
      run++;
      uint64_t q = a[i].k & qmask;
      int64_t o = offs[p] + i;
      out_lab[o] = a[i].lab;
      switch (key_bytes) {
        case 2: ((uint16_t*)out_keys)[o] = (uint16_t)q; break;
        case 4: ((uint32_t*)out_keys)[o] = (uint32_t)q; break;
        default: ((uint64_t*)out_keys)[o] = q; break;
      }
    }
    if (m > 0) {
      if (run > 255) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
        overflow = 1;
      } else {
        sizes[prev_r] = (uint8_t)run;
      }
    }
  }
  return overflow ? -1 : 0;
}

// lElement::AddToCount saturation (dataType.hh:333-334): each occurrence's
// count is added only while the running 8-bit counter stays below 255.
// Groups are contiguous: group g spans [bounds[g], bounds[g+1]).
void saturating_group_sum(const int64_t* bounds, int64_t ngroups,
                          const int64_t* v, int64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t g = 0; g < ngroups; g++) {
    int64_t s = 0;
    for (int64_t i = bounds[g]; i < bounds[g + 1]; i++) {
      if (s + v[i] < 255) s += v[i];
    }
    out[g] = s;
  }
}

}  // extern "C"
