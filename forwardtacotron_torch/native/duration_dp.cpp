// Native shortest-monotonic-path DP for duration extraction (the port's
// copy of forwardtacotron_tpu/native/duration_dp.cpp).
//
// Same algorithm and tie-breaking as the numpy implementation in
// duration/extractor.py::_shortest_monotonic_path_dp (the DAG-DP
// reformulation of the reference's scipy Dijkstra at
// duration_extraction/duration_extractor.py:55-65): min-cost monotonic path
// from (0,0) to (rows-1, cols-1) with right/down/diag moves, step cost =
// weight of the node entered. The numpy DP's inner right-scan is a
// sequential Python loop (rows*cols iterations); this version runs the whole
// table in native code and is loaded through ctypes (plain extern "C"
// symbols, no binding library).
//
// Tie-breaking parity with the numpy path (exact, same IEEE double ops in
// the same order): diag wins ties against down (diag <= down), a rightward
// relaxation must be strictly better (via_right < d[j]).

#include <cstddef>
#include <cstdint>
#include <vector>
#include <limits>

extern "C" {

// w: [rows, cols] row-major doubles (node-entry costs, already clipped).
// path_i/path_j: caller-allocated buffers of capacity >= rows + cols.
// Returns the number of path nodes written (start (0,0) .. end), or -1 on
// invalid input.
int duration_dp_path(const double* w, int64_t rows, int64_t cols,
                     int32_t* path_i, int32_t* path_j) {
    if (rows <= 0 || cols <= 0) return -1;
    const double INF = std::numeric_limits<double>::infinity();

    // rolling distance rows; full move table for backtracking
    std::vector<double> prev(cols), cur(cols);
    std::vector<int8_t> move(static_cast<size_t>(rows) * cols, 0);

    prev[0] = 0.0;
    for (int64_t j = 1; j < cols; ++j) prev[j] = prev[j - 1] + w[j];

    for (int64_t i = 1; i < rows; ++i) {
        const double* wi = w + i * cols;
        int8_t* mi = move.data() + i * cols;
        // down/diag candidates, then sequential rightward relaxation
        {
            double down = prev[0];
            cur[0] = down + wi[0];
            mi[0] = 1;  // only down enters column 0
        }
        for (int64_t j = 1; j < cols; ++j) {
            const double down = prev[j];
            const double diag = prev[j - 1];
            double best;
            int8_t m;
            if (diag <= down) { best = diag; m = 2; }
            else              { best = down; m = 1; }
            double d = best + wi[j];
            const double via_right = cur[j - 1] + wi[j];
            if (via_right < d) { d = via_right; m = 0; }
            cur[j] = d;
            mi[j] = m;
        }
        prev.swap(cur);
    }

    // backtrack from (rows-1, cols-1)
    int64_t i = rows - 1, j = cols - 1;
    int64_t n = 0;
    const int64_t cap = rows + cols;
    while (!(i == 0 && j == 0)) {
        if (n >= cap) return -1;  // cannot happen on a monotonic path
        path_i[n] = static_cast<int32_t>(i);
        path_j[n] = static_cast<int32_t>(j);
        ++n;
        switch (move[i * cols + j]) {
            case 0: --j; break;
            case 1: --i; break;
            default: --i; --j; break;
        }
    }
    path_i[n] = 0;
    path_j[n] = 0;
    ++n;

    // reverse in place to start..end order
    for (int64_t a = 0, b = n - 1; a < b; ++a, --b) {
        int32_t ti = path_i[a]; path_i[a] = path_i[b]; path_i[b] = ti;
        int32_t tj = path_j[a]; path_j[a] = path_j[b]; path_j[b] = tj;
    }
    return static_cast<int>(n);
}

}  // extern "C"
