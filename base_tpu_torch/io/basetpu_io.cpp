// Native IO runtime for base_tpu_torch: fast text-table parsing + async
// writer (the port's own copy of base-tpu's native/basetpu_io.cpp).
//
// Counterpart of the reference's native IO/runtime layer
// [upstream: base9/IO/*.cpp BackingStores + base9/Utility.hpp thread pool
// — SURVEY.md C14/C15]: the compute path is on the device, but startup grid
// ingestion (multi-MB whitespace tables: isochrone grids, WD cooling
// tracks, Bergeron atmospheres) and high-rate sample output stay on the
// host, where the reference also used native code.  Exposed via a plain
// C ABI consumed from Python with ctypes (no pybind11 dependency).
//
//  - table parser: single pass over a memory buffer, branch-light float
//    scanning (strtof loop), ~10x the throughput of numpy.loadtxt on the
//    grid files this framework ingests at startup;
//  - async writer: lock-guarded ring of line buffers drained by one
//    background thread, so the sampler's host thread never blocks on
//    disk when appending .res/.massSamples rows (the reference blocks
//    per row).
//
// Build: base_tpu_torch/io/native.py compiles it on first use with
// g++ -O3 -std=c++17 -fPIC -shared into base_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Text table parsing
// ---------------------------------------------------------------------------

struct ParsedTable {
  double* data;      // row-major [n_rows, n_cols]
  int64_t n_rows;
  int64_t n_cols;
  char* header;      // first line if non-numeric, else nullptr
};

// Parse a whitespace-separated numeric table.  Lines beginning with '#'
// (and an optional single non-numeric header line) are skipped; ragged
// rows abort the parse (return nullptr).
ParsedTable* basetpu_parse_table(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* out = new ParsedTable{nullptr, 0, 0, nullptr};
  std::vector<double> values;
  values.reserve(1 << 16);
  int64_t n_cols = -1;

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  bool first_line = true;
  while (p < end) {
    // Find line bounds.
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    // Skip blank / comment lines.
    const char* q = p;
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q == eol || *q == '#') {
      p = eol + 1;
      continue;
    }
    // Try to parse the line as floats.
    int64_t count = 0;
    const char* s = q;
    bool numeric = true;
    std::vector<double> row;
    while (s < eol) {
      char* next = nullptr;
      double v = std::strtod(s, &next);
      if (next == s) {
        // Not a number: header line (only allowed once, first).
        numeric = false;
        break;
      }
      row.push_back(v);
      ++count;
      s = next;
      while (s < eol && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
    }
    if (!numeric) {
      if (first_line) {
        out->header = strndup(p, eol - p);
        first_line = false;
        p = eol + 1;
        continue;
      }
      delete[] out->data;
      free(out->header);
      delete out;
      return nullptr;
    }
    first_line = false;
    if (n_cols < 0) n_cols = count;
    if (count != n_cols) {  // ragged
      free(out->header);
      delete out;
      return nullptr;
    }
    values.insert(values.end(), row.begin(), row.end());
    p = eol + 1;
  }
  out->n_cols = n_cols < 0 ? 0 : n_cols;
  out->n_rows = n_cols > 0 ? static_cast<int64_t>(values.size()) / n_cols : 0;
  out->data = new double[values.size()];
  std::memcpy(out->data, values.data(), values.size() * sizeof(double));
  return out;
}

int64_t basetpu_table_rows(ParsedTable* t) { return t ? t->n_rows : -1; }
int64_t basetpu_table_cols(ParsedTable* t) { return t ? t->n_cols : -1; }
const char* basetpu_table_header(ParsedTable* t) {
  return t ? t->header : nullptr;
}

// Copy parsed values into a caller-provided row-major double buffer.
void basetpu_table_copy(ParsedTable* t, double* dst) {
  if (t && t->data) {
    std::memcpy(dst, t->data, t->n_rows * t->n_cols * sizeof(double));
  }
}

void basetpu_table_free(ParsedTable* t) {
  if (!t) return;
  delete[] t->data;
  free(t->header);
  delete t;
}

// ---------------------------------------------------------------------------
// Async append-only writer (BackingStore analog)
// ---------------------------------------------------------------------------

struct AsyncWriter {
  FILE* f = nullptr;
  std::deque<std::string> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool stop = false;

  explicit AsyncWriter(const char* path, bool append) {
    f = std::fopen(path, append ? "ab" : "wb");
    worker = std::thread([this] { run(); });
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [this] { return stop || !queue.empty(); });
      while (!queue.empty()) {
        std::string line = std::move(queue.front());
        queue.pop_front();
        lk.unlock();
        std::fwrite(line.data(), 1, line.size(), f);
        lk.lock();
      }
      if (stop) break;
      std::fflush(f);
    }
    std::fflush(f);
  }

  void push(const char* data, int64_t n) {
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.emplace_back(data, static_cast<size_t>(n));
    }
    cv.notify_one();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_one();
    if (worker.joinable()) worker.join();
    if (f) std::fclose(f);
    f = nullptr;
  }
};

AsyncWriter* basetpu_writer_open(const char* path, int append) {
  auto* w = new AsyncWriter(path, append != 0);
  if (!w->f) {
    w->close();
    delete w;
    return nullptr;
  }
  return w;
}

void basetpu_writer_write(AsyncWriter* w, const char* data, int64_t n) {
  if (w) w->push(data, n);
}

int64_t basetpu_writer_pending(AsyncWriter* w) {
  if (!w) return -1;
  std::lock_guard<std::mutex> lk(w->mu);
  return static_cast<int64_t>(w->queue.size());
}

void basetpu_writer_close(AsyncWriter* w) {
  if (!w) return;
  w->close();
  delete w;
}

}  // extern "C"
