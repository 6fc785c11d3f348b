// Native codec for uncorrected-word LLR datasets (and other tab-separated
// float tables), the host side of `ldpc_error_floor_tpu_torch/io/
// uncor_files.py`.  File format of the reference (`Print_Functions.py:6-10`
// reader, `:120-126` writer): tab-separated rows, 3 leading metadata
// columns, values stored as the NEGATED channel LLRs with "%.1f"
// formatting.
//
// Harvesting deep in the error floor produces datasets of 10^4-10^6 rows x
// ~580 columns; np.loadtxt/np.savetxt serialise the host against the card.
// This codec parses and formats the values in C++.  It is built with
// g++ at first use and loaded with ctypes (`native/__init__.py`); the NumPy
// functions of `io/uncor_files.py` are the reference it is held to, byte
// for byte.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (driven by native/__init__.py).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Read the whole file into a NUL-terminated heap buffer.  Returns nullptr on
// failure; caller frees.
char* slurp(const char* path, long* size_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 0) { std::fclose(f); return nullptr; }
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return nullptr; }
    long got = static_cast<long>(std::fread(buf, 1, size, f));
    std::fclose(f);
    if (got != size) { std::free(buf); return nullptr; }
    buf[size] = '\0';
    *size_out = size;
    return buf;
}

inline bool is_delim(char c) { return c == '\t' || c == ' ' || c == '\r'; }

const double kPow10[10] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9};

// Fast fixed-point float parse for the dominant "%.1f"-style on-disk format
// (sign, <=9 integer digits, optional '.', <=9 fraction digits).  Falls back
// to strtof for exponents / long digit strings.  Advances *pp past the
// number; sets *ok=false (without consuming) if no number is present.
inline float parse_float(char** pp, bool* ok) {
    char* p = *pp;
    bool neg = false;
    if (*p == '-') { neg = true; p++; }
    else if (*p == '+') { p++; }
    long ip = 0; int ni = 0;
    while (*p >= '0' && *p <= '9' && ni < 10) { ip = ip * 10 + (*p - '0'); ni++; p++; }
    long fp = 0; int nf = 0;
    if (*p == '.' && ni < 10) {
        p++;
        while (*p >= '0' && *p <= '9' && nf < 10) { fp = fp * 10 + (*p - '0'); nf++; p++; }
    }
    if (ni == 10 || nf == 10 || *p == 'e' || *p == 'E' ||
        (ni == 0 && nf == 0)) {
        char* next = nullptr;
        float v = std::strtof(*pp, &next);
        *ok = next != *pp;
        *pp = next;
        return v;
    }
    double v = (static_cast<double>(ip) * kPow10[nf] + fp) / kPow10[nf];
    *pp = p;
    *ok = true;
    return static_cast<float>(neg ? -v : v);
}

// Fast "%.1f" formatting for values that are exact multiples of 0.5 (the
// QMS-grid case covering harvested LLRs); exact printf fallback otherwise.
inline char* format_1f(char* q, double d) {
    double twice = d * 2.0;
    if (twice == static_cast<long>(twice) && twice < 2e9 && twice > -2e9) {
        long t = static_cast<long>(twice) * 5;  // value * 10, exact
        if (t < 0) { *q++ = '-'; t = -t; }
        else if (d == 0.0 && std::signbit(d)) { *q++ = '-'; }  // "-0.0"
        char tmp[24];
        int n = 0;
        long ipart = t / 10;
        do { tmp[n++] = '0' + (ipart % 10); ipart /= 10; } while (ipart);
        while (n) *q++ = tmp[--n];
        *q++ = '.';
        *q++ = '0' + (t % 10);
        return q;
    }
    return q + std::snprintf(q, 48, "%.1f", d);
}

}  // namespace

extern "C" {

// Count non-empty lines and the column count of the first non-empty line.
// Returns rows (0 for an empty/absent table), -1 on I/O failure.
long uncor_count(const char* path, long* cols) {
    long size = 0;
    char* buf = slurp(path, &size);
    if (!buf) return -1;
    long rows = 0;
    long first_cols = 0;
    const char* p = buf;
    const char* end = buf + size;
    while (p < end) {
        long c = 0;
        bool in_field = false;
        while (p < end && *p != '\n') {
            if (is_delim(*p)) { in_field = false; }
            else if (!in_field) { in_field = true; c++; }
            p++;
        }
        if (p < end) p++;  // consume '\n'
        if (c > 0) {
            rows++;
            if (first_cols == 0) first_cols = c;
        }
    }
    *cols = first_cols;
    std::free(buf);
    return rows;
}

// Parse up to max_rows rows of n_cols floats, skipping skip_cols leading
// columns and scaling kept values by `scale` (-1.0f restores the p1/p0
// convention from the negated on-disk form).  `out` must hold
// max_rows * (n_cols - skip_cols) floats.  Returns rows parsed, or -1 on
// I/O error, -2 on a malformed row (wrong column count / bad float).
long uncor_parse(const char* path, long skip_cols, long n_cols,
                 float* out, long max_rows, float scale) {
    long size = 0;
    char* buf = slurp(path, &size);
    if (!buf) return -1;
    const long keep = n_cols - skip_cols;
    long row = 0;
    char* p = buf;
    char* end = buf + size;
    while (p < end && row < max_rows) {
        while (p < end && (*p == '\n' || is_delim(*p))) p++;
        if (p >= end) break;
        long c = 0;
        while (p < end && *p != '\n') {
            while (p < end && is_delim(*p)) p++;
            if (p >= end || *p == '\n') break;
            bool ok = false;
            float v = parse_float(&p, &ok);
            if (!ok) { std::free(buf); return -2; }
            if (c >= n_cols) { std::free(buf); return -2; }
            if (c >= skip_cols) out[row * keep + (c - skip_cols)] = v * scale;
            c++;
        }
        if (c != n_cols) { std::free(buf); return -2; }
        row++;
    }
    std::free(buf);
    return row;
}

// Append (or truncate+write) rows: `meta_cols` zero columns, then `cols`
// values scaled by `scale`, "%.1f", tab-separated, one row per line —
// byte-identical to the reference writer / np.savetxt(fmt='%.1f').
// Returns 0, or -1 on I/O failure.
int uncor_write(const char* path, const float* data, long rows, long cols,
                long meta_cols, float scale, int append) {
    FILE* f = std::fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    // worst-case "%.1f" of a float is ~48 chars; line buffer sized to fit
    const long line_cap = (meta_cols + cols) * 50 + 2;
    char* line = static_cast<char*>(std::malloc(line_cap));
    if (!line) { std::fclose(f); return -1; }
    for (long r = 0; r < rows; r++) {
        char* q = line;
        for (long m = 0; m < meta_cols; m++) {
            if (m) *q++ = '\t';
            *q++ = '0'; *q++ = '.'; *q++ = '0';
        }
        for (long c = 0; c < cols; c++) {
            if (c || meta_cols) *q++ = '\t';
            q = format_1f(q, static_cast<double>(data[r * cols + c]) *
                             static_cast<double>(scale));
        }
        *q++ = '\n';
        if (std::fwrite(line, 1, q - line, f) != static_cast<size_t>(q - line)) {
            std::free(line); std::fclose(f); return -1;
        }
    }
    std::free(line);
    if (std::fclose(f) != 0) return -1;
    return 0;
}

}  // extern "C"
