// Native host kernels of feddlib_tpu_torch: the hot host phases of setup.
//
//   - MEDIT .mesh parsing (reference: core/Mesh/MeshFileReader.cpp), a
//     two-pass whitespace-token parser;
//   - the symbolic fillComplete: COO (row, col) pairs -> CSR pattern and
//     the slot of every COO entry, which the numeric assembly sums into;
//   - deterministic recursive coordinate bisection.
//
// The semantics are those of feddlib_tpu/native/fedd_native.cpp; the
// symbolic phase uses another algorithm with the same output (see
// coo_to_csr).  Exposed as extern "C" for ctypes; built at first use by
// feddlib_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MEDIT .mesh parser
// ---------------------------------------------------------------------------
// Pass 1: sizes.  Returns 0 on success, 1 if the file cannot be opened.
//   out_sizes = [dim, n_vertices, n_edges, n_triangles, n_tetrahedra]
// Tokens are whitespace-separated words ('#' is not a comment here);
// Vertices rows are x y z flag (z present even in 2D); 'End' stops the read.
int medit_sizes(const char* path, int64_t* out_sizes) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char word[256];
  int64_t dim = 0, nv = 0, ne = 0, nt = 0, ntet = 0;
  while (fscanf(f, "%255s", word) == 1) {
    if (!strcmp(word, "Dimension")) {
      if (fscanf(f, "%ld", &dim) != 1) { fclose(f); return 2; }
    } else if (!strcmp(word, "Vertices")) {
      if (fscanf(f, "%ld", &nv) != 1) { fclose(f); return 2; }
      for (int64_t i = 0; i < nv * 4; i++)
        if (fscanf(f, "%255s", word) != 1) break;
    } else if (!strcmp(word, "Edges")) {
      if (fscanf(f, "%ld", &ne) != 1) { fclose(f); return 2; }
      for (int64_t i = 0; i < ne * 3; i++)
        if (fscanf(f, "%255s", word) != 1) break;
    } else if (!strcmp(word, "Triangles")) {
      if (fscanf(f, "%ld", &nt) != 1) { fclose(f); return 2; }
      for (int64_t i = 0; i < nt * 4; i++)
        if (fscanf(f, "%255s", word) != 1) break;
    } else if (!strcmp(word, "Tetrahedra")) {
      if (fscanf(f, "%ld", &ntet) != 1) { fclose(f); return 2; }
      for (int64_t i = 0; i < ntet * 5; i++)
        if (fscanf(f, "%255s", word) != 1) break;
    } else if (!strcmp(word, "End")) {
      break;
    }
  }
  fclose(f);
  out_sizes[0] = dim; out_sizes[1] = nv; out_sizes[2] = ne;
  out_sizes[3] = nt; out_sizes[4] = ntet;
  return 0;
}

// Pass 2: fill caller-allocated buffers (sized from pass 1; `cap` holds
// pass 1's out_sizes).  vertices: [nv, 3] doubles + vflags [nv] int32 (z
// column kept even in 2D); edges [ne, 2] int64 0-based + eflags; triangles
// [nt, 3] + tflags; tets [ntet, 4] + tetflags.  Returns 0, 3 on a short or
// malformed row, or 4 if a block holds more rows than its buffer (a block
// repeated in the file).
int medit_read(const char* path, const int64_t* cap, double* verts,
               int32_t* vflags, int64_t* edges, int32_t* eflags,
               int64_t* tris, int32_t* tflags, int64_t* tets,
               int32_t* tetflags) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char word[256];
  while (fscanf(f, "%255s", word) == 1) {
    if (!strcmp(word, "Dimension")) {
      int64_t d; if (fscanf(f, "%ld", &d) != 1) { fclose(f); return 2; }
    } else if (!strcmp(word, "Vertices")) {
      int64_t n; if (fscanf(f, "%ld", &n) != 1) { fclose(f); return 2; }
      if (n > cap[1]) { fclose(f); return 4; }
      for (int64_t i = 0; i < n; i++) {
        long fl;
        if (fscanf(f, "%lf %lf %lf %ld", &verts[3 * i], &verts[3 * i + 1],
                   &verts[3 * i + 2], &fl) != 4) { fclose(f); return 3; }
        vflags[i] = (int32_t)fl;
      }
    } else if (!strcmp(word, "Edges")) {
      int64_t n; if (fscanf(f, "%ld", &n) != 1) { fclose(f); return 2; }
      if (n > cap[2]) { fclose(f); return 4; }
      for (int64_t i = 0; i < n; i++) {
        long a, b, fl;
        if (fscanf(f, "%ld %ld %ld", &a, &b, &fl) != 3) { fclose(f); return 3; }
        edges[2 * i] = a - 1; edges[2 * i + 1] = b - 1;
        eflags[i] = (int32_t)fl;
      }
    } else if (!strcmp(word, "Triangles")) {
      int64_t n; if (fscanf(f, "%ld", &n) != 1) { fclose(f); return 2; }
      if (n > cap[3]) { fclose(f); return 4; }
      for (int64_t i = 0; i < n; i++) {
        long a, b, c, fl;
        if (fscanf(f, "%ld %ld %ld %ld", &a, &b, &c, &fl) != 4) {
          fclose(f); return 3;
        }
        tris[3 * i] = a - 1; tris[3 * i + 1] = b - 1; tris[3 * i + 2] = c - 1;
        tflags[i] = (int32_t)fl;
      }
    } else if (!strcmp(word, "Tetrahedra")) {
      int64_t n; if (fscanf(f, "%ld", &n) != 1) { fclose(f); return 2; }
      if (n > cap[4]) { fclose(f); return 4; }
      for (int64_t i = 0; i < n; i++) {
        long a, b, c, d, fl;
        if (fscanf(f, "%ld %ld %ld %ld %ld", &a, &b, &c, &d, &fl) != 5) {
          fclose(f); return 3;
        }
        tets[4 * i] = a - 1; tets[4 * i + 1] = b - 1;
        tets[4 * i + 2] = c - 1; tets[4 * i + 3] = d - 1;
        tetflags[i] = (int32_t)fl;
      }
    } else if (!strcmp(word, "End")) {
      break;
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// symbolic fillComplete: COO (rows, cols) -> CSR pattern + slot map
// ---------------------------------------------------------------------------
// Row-bucketed, one pass over the output: a counting sort of the entries by
// row, then a sort of each row's (col, COO index) pairs by col.  Each row's
// pairs fit in cache, and no row * n_cols + col key is formed, so nothing
// overflows for any int64 shape.  Fills indptr [n_rows + 1], indices (the
// caller allocates n_coo, of which the first nnz are written: the unique
// columns, sorted within each row) and slot_of_coo [n_coo] (the rank of
// each entry's (row, col) among the unique pairs).  Returns nnz, or -1 if a
// row and -2 if a column lies outside the matrix.
int64_t coo_to_csr(const int64_t* rows, const int64_t* cols, int64_t n_coo,
                   int64_t n_rows_mat, int64_t n_cols_mat, int64_t* indptr,
                   int64_t* indices, int64_t* slot_of_coo) {
  std::vector<int64_t> start(n_rows_mat + 1, 0);
  for (int64_t i = 0; i < n_coo; i++) {
    if (rows[i] < 0 || rows[i] >= n_rows_mat) return -1;
    if (cols[i] < 0 || cols[i] >= n_cols_mat) return -2;
    start[rows[i] + 1]++;
  }
  for (int64_t r = 0; r < n_rows_mat; r++) start[r + 1] += start[r];
  struct Entry { int64_t col, idx; };
  std::vector<Entry> bucket(n_coo);
  std::vector<int64_t> fill(start.begin(), start.end() - 1);
  for (int64_t i = 0; i < n_coo; i++)
    bucket[fill[rows[i]]++] = Entry{cols[i], i};
  // equal columns share a slot, so their order within a row is immaterial
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t r = 0; r < n_rows_mat; r++) {
    Entry* lo = bucket.data() + start[r];
    Entry* hi = bucket.data() + start[r + 1];
    std::sort(lo, hi, [](const Entry& a, const Entry& b) {
      return a.col < b.col;
    });
    for (Entry* e = lo; e < hi; e++) {
      if (e == lo || e->col != e[-1].col) indices[nnz++] = e->col;
      slot_of_coo[e->idx] = nnz - 1;
    }
    indptr[r + 1] = nnz;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// deterministic recursive coordinate bisection
// ---------------------------------------------------------------------------
// Split the longest axis of the bounding box (the first of equal ones) at
// the rank round-half-up(n * nl / np) of the (coordinate, id) order; the
// first nl parts take the lower side.
static void rcb_rec(const double* cent, int dim, int64_t* ids, int64_t n,
                    int np, int base, int32_t* out) {
  if (np == 1) {
    for (int64_t i = 0; i < n; i++) out[ids[i]] = base;
    return;
  }
  int nl = np / 2;
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; i++)
    for (int d = 0; d < dim; d++) {
      double v = cent[ids[i] * dim + d];
      if (v < lo[d]) lo[d] = v;
      if (v > hi[d]) hi[d] = v;
    }
  int ax = 0;
  for (int d = 1; d < dim; d++)
    if (hi[d] - lo[d] > hi[ax] - lo[ax]) ax = d;
  std::stable_sort(ids, ids + n, [&](int64_t a, int64_t b) {
    double va = cent[a * dim + ax], vb = cent[b * dim + ax];
    if (va != vb) return va < vb;
    return a < b;
  });
  int64_t k = (int64_t)((double)n * nl / np + 0.5);
  rcb_rec(cent, dim, ids, k, nl, base, out);
  rcb_rec(cent, dim, ids + k, n - k, np - nl, base + nl, out);
}

// centroids [n, dim] (dim 1..3), n_parts >= 1; out [n] part of each point.
int rcb_partition(const double* centroids, int64_t n, int dim, int n_parts,
                  int32_t* out) {
  if (dim < 1 || dim > 3 || n_parts < 1) return 1;
  std::vector<int64_t> ids(n);
  std::iota(ids.begin(), ids.end(), 0);
  rcb_rec(centroids, dim, ids.data(), n, n_parts, 0, out);
  return 0;
}

}  // extern "C"
