// Exact dense linear-assignment solver (Hungarian algorithm with
// potentials, O(n^3)): the port's native host oracle, a copy of
// mmmot_tpu/native/lap.cpp.
//
// The association ILP reduces exactly to a square assignment problem
// (mmmot_tpu_torch/assoc/cost.py); this solver returns its optimum on
// the host, much faster than a MILP solver at KITTI sizes.  It backs the
// "native" solver of mmmot_tpu_torch/assoc/solve.py and the parity
// tests; the device solvers live in mmmot_tpu_torch/assoc.  Built with
// g++ by mmmot_tpu_torch/kernels/build.py::build_host (no -march=native:
// the library must not depend on the host that built it).
//
// C ABI:
//   lap_solve(cost, n, row_to_col) -> objective (minimisation)
//   lap_solve_batch(costs, b, n, row_to_col) -> 0
//
// cost is row-major [n, n] float64.  For maximisation, negate the costs.

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

double lap_solve(const double* cost, int32_t n, int32_t* row_to_col) {
    const double INF = std::numeric_limits<double>::infinity();
    // 1-indexed potentials over rows (u) and columns (v); p[j] = row
    // matched to column j (0 = none); way[j] = previous column on the
    // shortest alternating path.
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
    std::vector<int32_t> p(n + 1, 0), way(n + 1, 0);

    for (int32_t i = 1; i <= n; ++i) {
        p[0] = i;
        int32_t j0 = 0;
        std::vector<double> minv(n + 1, INF);
        std::vector<char> used(n + 1, 0);
        do {
            used[j0] = 1;
            const int32_t i0 = p[j0];
            double delta = INF;
            int32_t j1 = -1;
            const double* row = cost + (int64_t)(i0 - 1) * n;
            for (int32_t j = 1; j <= n; ++j) {
                if (used[j]) continue;
                const double cur = row[j - 1] - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (int32_t j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else         { minv[j] -= delta; }
            }
            j0 = j1;
        } while (p[j0] != 0);
        // Augment along the found path.
        do {
            const int32_t j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }

    double obj = 0.0;
    for (int32_t j = 1; j <= n; ++j) {
        row_to_col[p[j] - 1] = j - 1;
        obj += cost[(int64_t)(p[j] - 1) * n + (j - 1)];
    }
    return obj;
}

int32_t lap_solve_batch(const double* costs, int32_t b, int32_t n,
                        int32_t* row_to_col) {
    for (int32_t k = 0; k < b; ++k) {
        lap_solve(costs + (int64_t)k * n * n, n, row_to_col + (int64_t)k * n);
    }
    return 0;
}

}  // extern "C"
