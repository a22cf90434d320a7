// Native setup runtime for stfem_tpu.
//
// The compute path is JAX/XLA on the accelerator; this library covers the host-side
// runtime work that the reference implements in C++ (deal.II's DoF/sparsity
// setup and DataOut writers): index-map generation for the banded assembled
// operators and Vanka patches, dof valence fields, and a fast binary VTK
// (structured-grid) solution writer.  Exposed via a plain C ABI for ctypes;
// Python falls back to NumPy implementations when the library is absent.
//
// Build: make -C native   (g++ -O3 -march=native -fPIC -shared)
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Flat scatter indices for banded assembly: for each cell c and local pair
// (a, b), idx = gdof(c, a) * n_off + off(a, b), where gdof is the flat
// row-major dof index and off the flat per-axis offset index in [0, 2k]^dim.
// cells: per-axis cell counts (length dim); out has size n_cells * A * A.
void stfem_band_indices(int dim, const int64_t *cells, int degree,
                        int64_t *out) {
  const int k = degree;
  const int npa = k + 1;
  int64_t A = 1, C = 1, n_off = 1;
  std::vector<int64_t> dof_shape(dim), dof_stride(dim), off_stride(dim);
  for (int d = 0; d < dim; ++d) {
    A *= npa;
    C *= cells[d];
    n_off *= 2 * k + 1;
    dof_shape[d] = cells[d] * k + 1;
  }
  dof_stride[dim - 1] = 1;
  off_stride[dim - 1] = 1;
  for (int d = dim - 2; d >= 0; --d) {
    dof_stride[d] = dof_stride[d + 1] * dof_shape[d + 1];
    off_stride[d] = off_stride[d + 1] * (2 * k + 1);
  }

  // local multi-indices
  std::vector<std::vector<int>> loc(A, std::vector<int>(dim));
  for (int64_t a = 0; a < A; ++a) {
    int64_t r = a;
    for (int d = dim - 1; d >= 0; --d) {
      loc[a][d] = static_cast<int>(r % npa);
      r /= npa;
    }
  }

  const unsigned n_threads =
      std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> threads;
  auto worker = [&](int64_t c0, int64_t c1) {
    std::vector<int64_t> cidx(dim);
    for (int64_t c = c0; c < c1; ++c) {
      int64_t r = c;
      for (int d = dim - 1; d >= 0; --d) {
        cidx[d] = r % cells[d];
        r /= cells[d];
      }
      for (int64_t a = 0; a < A; ++a) {
        int64_t g = 0;
        for (int d = 0; d < dim; ++d)
          g += (cidx[d] * k + loc[a][d]) * dof_stride[d];
        for (int64_t b = 0; b < A; ++b) {
          int64_t off = 0;
          for (int d = 0; d < dim; ++d)
            off += (loc[b][d] - loc[a][d] + k) * off_stride[d];
          out[(c * A + a) * A + b] = g * n_off + off;
        }
      }
    }
  };
  int64_t chunk = (C + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    int64_t c0 = t * chunk, c1 = std::min<int64_t>(C, c0 + chunk);
    if (c0 >= c1) break;
    threads.emplace_back(worker, c0, c1);
  }
  for (auto &th : threads) th.join();
}

// Per-dof cell-multiplicity (valence) on the tensor dof grid (row-major).
void stfem_dof_valence(int dim, const int64_t *cells, int degree,
                       double *out) {
  const int k = degree;
  std::vector<int64_t> dof_shape(dim);
  int64_t n = 1;
  for (int d = 0; d < dim; ++d) {
    dof_shape[d] = cells[d] * k + 1;
    n *= dof_shape[d];
  }
  std::vector<int64_t> idx(dim, 0);
  for (int64_t i = 0; i < n; ++i) {
    double v = 1.0;
    for (int d = 0; d < dim; ++d) {
      int64_t g = idx[d];
      bool shared = (k > 0) && (g % k == 0) && g != 0 && g != dof_shape[d] - 1;
      v *= shared ? 2.0 : 1.0;
    }
    out[i] = v;
    for (int d = dim - 1; d >= 0; --d) {
      if (++idx[d] < dof_shape[d]) break;
      idx[d] = 0;
    }
  }
}

// Binary legacy-VTK structured-grid writer for a scalar field on the dof
// grid (the analogue of the reference's DataOut VTU dumps, tp_01.cc:636-644).
// points: n x 3 doubles (pad 2D with z=0), values: n doubles, dims: [nx,ny,nz]
int stfem_write_vtk(const char *path, const int64_t *dims,
                    const double *points, const double *values,
                    const char *name) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  int64_t n = dims[0] * dims[1] * dims[2];
  fprintf(f, "# vtk DataFile Version 3.0\nstfem_tpu solution\nBINARY\n");
  fprintf(f, "DATASET STRUCTURED_GRID\nDIMENSIONS %lld %lld %lld\n",
          (long long)dims[0], (long long)dims[1], (long long)dims[2]);
  fprintf(f, "POINTS %lld double\n", (long long)n);
  // legacy VTK is big-endian
  std::vector<double> buf(3 * n);
  auto swap8 = [](double x) {
    uint64_t u;
    memcpy(&u, &x, 8);
    u = __builtin_bswap64(u);
    memcpy(&x, &u, 8);
    return x;
  };
  for (int64_t i = 0; i < 3 * n; ++i) buf[i] = swap8(points[i]);
  fwrite(buf.data(), 8, 3 * n, f);
  fprintf(f, "\nPOINT_DATA %lld\nSCALARS %s double 1\nLOOKUP_TABLE default\n",
          (long long)n, name);
  buf.resize(n);
  for (int64_t i = 0; i < n; ++i) buf[i] = swap8(values[i]);
  fwrite(buf.data(), 8, n, f);
  fprintf(f, "\n");
  fclose(f);
  return 0;
}

}  // extern "C"
