// Native ingest + output runtime for bella_tpu.
//
// Re-implements the roles of the reference's C I/O layer:
//   * kmercode/fq_reader.c  - block FASTQ parsing (here: one mmap'd
//     pass emitting 2-bit codes, offsets, name spans, qual error sum)
//   * include/overlap.hpp:603-640 - bulk overlap-row output (here:
//     a single formatted write of M4/overlap rows from arrays)
//
// Exposed as a C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Branch-free 2-bit base code (matches kmercode/Kmer.cpp:215-216).
static inline uint8_t base_code(uint8_t c) {
    uint8_t x = (c & 4) >> 1;
    return x + ((x ^ (c & 2)) >> 1);
}

// First pass: count records and total sequence bytes.
// Returns 0 on success.
int fastq_scan(const char* path, int64_t* num_reads, int64_t* total_bases) {
    struct stat st;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t n = st.st_size;
    const char* buf =
        (const char*)mmap(nullptr, n ? n : 1, PROT_READ, MAP_PRIVATE, fd, 0);
    if (buf == MAP_FAILED) { close(fd); return -1; }

    int64_t reads = 0, bases = 0;
    size_t i = 0;
    while (i < n) {
        // record = 4 lines
        const char* nl1 = (const char*)memchr(buf + i, '\n', n - i);
        if (!nl1) break;
        size_t seq_start = nl1 - buf + 1;
        const char* nl2 = (const char*)memchr(buf + seq_start, '\n', n - seq_start);
        if (!nl2) break;
        size_t plus_start = nl2 - buf + 1;
        const char* nl3 = (const char*)memchr(buf + plus_start, '\n', n - plus_start);
        if (!nl3) break;
        size_t qual_start = nl3 - buf + 1;
        const char* nl4 = (const char*)memchr(buf + qual_start, '\n', n - qual_start);
        size_t qual_end = nl4 ? (size_t)(nl4 - buf) : n;
        if (!nl4 && qual_end - qual_start < (size_t)(nl2 - (buf + seq_start)))
            break;  // truncated final record: drop (parser parity)
        reads++;
        bases += (int64_t)(nl2 - (buf + seq_start));
        i = nl4 ? qual_end + 1 : n;
    }
    *num_reads = reads;
    *total_bases = bases;
    munmap((void*)buf, n ? n : 1);
    close(fd);
    return 0;
}

// Record-boundary resync: first record start at byte >= pos (the role
// of get_fptr_for_next_record, kmercode/fq_reader.c:200-312). A FASTQ
// quality line may itself start with '@'; a line L is a header iff it
// starts with '@' AND line L+2 starts with '+' (sequence lines are
// base characters, never '+', so a quality line that starts with '@'
// fails the check and the true header two lines later passes it).
static size_t next_record_start(const char* buf, size_t n, size_t pos) {
    if (pos == 0) return 0;
    // back up one byte so a pos landing exactly on a line start is seen
    const char* nl = (const char*)memchr(buf + pos - 1, '\n', n - (pos - 1));
    if (!nl) return n;
    size_t line = nl - buf + 1;
    for (int tries = 0; tries < 4 && line < n; tries++) {
        if (buf[line] == '@') {
            // find start of line+2
            const char* a = (const char*)memchr(buf + line, '\n', n - line);
            if (!a) return n;
            const char* b = (const char*)memchr(a + 1, '\n', n - (a + 1 - buf));
            if (!b) return n;
            size_t third = b - buf + 1;
            if (third < n && buf[third] == '+') return line;
        }
        const char* next = (const char*)memchr(buf + line, '\n', n - line);
        if (!next) return n;
        line = next - buf + 1;
    }
    return n;
}

struct RangeStats { int64_t reads, bases, name_bytes; double errs; };

static double err_table[256];
static bool err_init = false;

// Parse records in buf[lo, hi): count-only when codes == nullptr, else
// fill the caller slices starting at the given output positions.
static RangeStats parse_range(const char* buf, size_t n, size_t lo, size_t hi,
                              uint8_t* codes, int64_t base_out,
                              int64_t* offsets, int64_t read_out,
                              char* name_buf, int64_t name_out,
                              int64_t* name_offs) {
    RangeStats s = {0, 0, 0, 0.0};
    size_t i = lo;
    while (i < hi && i < n) {
        const char* nl1 = (const char*)memchr(buf + i, '\n', n - i);
        if (!nl1) break;
        size_t name_start = i + 1;  // skip '@'
        size_t name_end = nl1 - buf;
        const char* nl2 = (const char*)memchr(buf + name_end + 1, '\n', n - name_end - 1);
        if (!nl2) break;
        size_t seq_start = name_end + 1;
        size_t seq_end = nl2 - buf;
        const char* nl3 = (const char*)memchr(buf + seq_end + 1, '\n', n - seq_end - 1);
        if (!nl3) break;
        size_t qual_start = nl3 - buf + 1;
        const char* nl4 = (const char*)memchr(buf + qual_start, '\n', n - qual_start);
        size_t qual_end = nl4 ? (size_t)(nl4 - buf) : n;
        size_t seq_len = seq_end - seq_start;
        if (!nl4 && qual_end - qual_start < seq_len) break;  // truncated

        size_t ne = name_start;
        while (ne < name_end && buf[ne] != ' ' && buf[ne] != '\t') ne++;
        int64_t nlen = (int64_t)(ne - name_start);

        if (codes) {
            memcpy(name_buf + name_out + s.name_bytes, buf + name_start, nlen);
            name_buf[name_out + s.name_bytes + nlen] = '\0';
            name_offs[read_out + s.reads + 1] =
                name_out + s.name_bytes + nlen + 1;
            for (size_t p = 0; p < seq_len; p++)
                codes[base_out + s.bases + p] =
                    base_code((uint8_t)buf[seq_start + p]);
            for (size_t p = 0; p < seq_len && qual_start + p < qual_end; p++)
                s.errs += err_table[(uint8_t)buf[qual_start + p]];
            offsets[read_out + s.reads + 1] = base_out + s.bases + (int64_t)seq_len;
        }
        s.name_bytes += nlen + 1;
        s.bases += (int64_t)seq_len;
        s.reads++;
        i = nl4 ? qual_end + 1 : n;
    }
    return s;
}

// Second pass: fill caller-allocated buffers, thread-partitioned over
// byte ranges resynced to record boundaries (the reference's OpenMP
// FASTQ split, kmercode/fq_reader.c:314-331, as std::thread ranges).
//   codes:     [total_bases] uint8 2-bit codes
//   offsets:   [num_reads+1] int64
//   name_buf:  [name_cap] char, '\0'-joined read names (first token)
//   name_offs: [num_reads+1] int64 into name_buf
//   err_sum:   [1] double, sum of 10^(-q/10) over all bases (Phred+33)
// Returns number of reads parsed, or -1.
int64_t fastq_parse(const char* path, uint8_t* codes, int64_t* offsets,
                    char* name_buf, int64_t name_cap, int64_t* name_offs,
                    double* err_sum) {
    struct stat st;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t n = st.st_size;
    const char* buf =
        (const char*)mmap(nullptr, n ? n : 1, PROT_READ, MAP_PRIVATE, fd, 0);
    if (buf == MAP_FAILED) { close(fd); return -1; }

    if (!err_init) {
        for (int q = 0; q < 256; q++)
            err_table[q] = pow(10.0, -((double)(q - 33)) / 10.0);
        err_init = true;
    }

    int T = (int)std::thread::hardware_concurrency();
    if (n < (size_t)(1 << 22)) T = 1;  // small files: one range
    const char* env = getenv("BELLA_PARSE_THREADS");
    if (env && atoi(env) > 0) T = atoi(env);  // explicit override wins
    if (T < 1) T = 1;
    if (T > 64) T = 64;

    // range starts resynced to record boundaries
    std::vector<size_t> starts(T + 1);
    for (int t = 0; t < T; t++)
        starts[t] = next_record_start(buf, n, (size_t)((n / T) * t));
    starts[T] = n;
    for (int t = 1; t < T; t++)  // monotone (tiny files)
        if (starts[t] < starts[t - 1]) starts[t] = starts[t - 1];

    // pass A: per-range counts
    std::vector<RangeStats> stats(T);
    {
        std::vector<std::thread> ths;
        for (int t = 0; t < T; t++)
            ths.emplace_back([&, t] {
                stats[t] = parse_range(buf, n, starts[t], starts[t + 1],
                                       nullptr, 0, nullptr, 0, nullptr, 0,
                                       nullptr);
            });
        for (auto& th : ths) th.join();
    }
    int64_t reads = 0, bases = 0, names = 0;
    std::vector<int64_t> r0(T), b0(T), n0(T);
    for (int t = 0; t < T; t++) {
        r0[t] = reads; b0[t] = bases; n0[t] = names;
        reads += stats[t].reads; bases += stats[t].bases;
        names += stats[t].name_bytes;
    }
    if (names > name_cap) { munmap((void*)buf, n ? n : 1); close(fd); return -2; }

    // pass B: parallel fill into disjoint output slices
    offsets[0] = 0;
    name_offs[0] = 0;
    double errs = 0.0;
    {
        std::vector<std::thread> ths;
        std::vector<double> perr(T, 0.0);
        for (int t = 0; t < T; t++)
            ths.emplace_back([&, t] {
                RangeStats s = parse_range(buf, n, starts[t], starts[t + 1],
                                           codes, b0[t], offsets, r0[t],
                                           name_buf, n0[t], name_offs);
                perr[t] = s.errs;
            });
        for (auto& th : ths) th.join();
        for (int t = 0; t < T; t++) errs += perr[t];
    }
    *err_sum = errs;
    munmap((void*)buf, n ? n : 1);
    close(fd);
    return reads;
}


// ----------------------------------------------------------------------
// Parallel bulk output: per-thread format buffers + byte prefix sums +
// concurrent pwrite at offsets into one preallocated file — the
// reference's parallel writer scheme (include/overlap.hpp:603-640).
// ----------------------------------------------------------------------

typedef int (*row_fmt_t)(char* out, int cap, int64_t i, const void* ctx);

static int64_t write_rows_parallel(const char* path, int append,
                                   int64_t nrows, row_fmt_t fmt,
                                   const void* ctx) {
    int T = (int)std::thread::hardware_concurrency();
    const char* env = getenv("BELLA_WRITE_THREADS");
    if (env && atoi(env) > 0) T = atoi(env);
    if (T < 1) T = 1;
    if (T > 64) T = 64;
    if (nrows < 4096 && !env) T = 1;

    std::vector<std::vector<char>> bufs(T);
    std::vector<std::thread> ths;
    for (int t = 0; t < T; t++)
        ths.emplace_back([&, t] {
            int64_t lo = nrows * t / T, hi = nrows * (t + 1) / T;
            std::vector<char>& b = bufs[t];
            b.reserve((size_t)(hi - lo) * 96);
            char line[1024];
            for (int64_t i = lo; i < hi; i++) {
                int m = fmt(line, (int)sizeof(line), i, ctx);
                if (m > (int)sizeof(line) - 1) m = (int)sizeof(line) - 1;
                b.insert(b.end(), line, line + m);
            }
        });
    for (auto& th : ths) th.join();

    int fd = open(path, O_WRONLY | O_CREAT | (append ? 0 : O_TRUNC), 0644);
    if (fd < 0) return -1;
    int64_t base = append ? (int64_t)lseek(fd, 0, SEEK_END) : 0;
    int64_t total = 0;
    std::vector<int64_t> offs(T + 1);
    for (int t = 0; t < T; t++) { offs[t] = total; total += (int64_t)bufs[t].size(); }
    offs[T] = total;
    if (ftruncate(fd, base + total) != 0) { close(fd); return -1; }
    std::vector<std::thread> wts;
    for (int t = 0; t < T; t++)
        wts.emplace_back([&, t] {
            const char* pbuf = bufs[t].data();
            int64_t left = (int64_t)bufs[t].size(), at = base + offs[t];
            while (left > 0) {
                ssize_t w = pwrite(fd, pbuf, (size_t)left, (off_t)at);
                if (w <= 0) break;
                pbuf += w; at += w; left -= w;
            }
        });
    for (auto& th : wts) th.join();
    close(fd);
    return total;
}

struct M4Ctx {
    const int32_t *read_h, *read_v, *count, *score;
    const int64_t* ov; const uint8_t* strand_rc;
    const int32_t *beg_v, *end_v, *beg_h, *end_h;
    const char* name_buf; const int64_t* name_offs; const int64_t* lens;
};

static int fmt_m4(char* out, int cap, int64_t i, const void* vctx) {
    const M4Ctx* c = (const M4Ctx*)vctx;
    int32_t h = c->read_h[i], v = c->read_v[i];
    return snprintf(out, cap,
        "%s\t%s\t%d\t%d\t%lld\t%c\t%d\t%d\t%lld\t%d\t%d\t%lld\n",
        c->name_buf + c->name_offs[v], c->name_buf + c->name_offs[h],
        c->count[i], c->score[i], (long long)c->ov[i],
        c->strand_rc[i] ? 'c' : 'n', c->beg_v[i], c->end_v[i],
        (long long)c->lens[v], c->beg_h[i], c->end_h[i],
        (long long)c->lens[h]);
}

struct PafCtx {
    const int32_t *read_h, *read_v, *score;
    const int64_t* ov; const uint8_t* strand_rc;
    const int32_t *beg_v, *end_v, *beg_h, *end_h;
    const char* name_buf; const int64_t* name_offs; const int64_t* lens;
};

static int fmt_paf(char* out, int cap, int64_t i, const void* vctx) {
    const PafCtx* c = (const PafCtx*)vctx;
    int32_t h = c->read_h[i], v = c->read_v[i];
    long long lh = (long long)c->lens[h];
    long long bh = c->beg_h[i], eh = c->end_h[i];
    char strand = '+';
    if (c->strand_rc[i]) {
        strand = '-';
        long long nb = lh - eh, ne = lh - bh;
        bh = nb; eh = ne;
    }
    return snprintf(out, cap,
        "%s\t%lld\t%d\t%d\t%c\t%s\t%lld\t%lld\t%lld\t%d\t%lld\t255\n",
        c->name_buf + c->name_offs[v], (long long)c->lens[v], c->beg_v[i],
        c->end_v[i], strand, c->name_buf + c->name_offs[h], lh, bh, eh,
        c->score[i], (long long)c->ov[i]);
}

struct OvCtx {
    const int32_t *read_h, *read_v, *count, *ov;
    const char* name_buf; const int64_t* name_offs; const int64_t* lens;
};

static int fmt_overlap(char* out, int cap, int64_t i, const void* vctx) {
    const OvCtx* c = (const OvCtx*)vctx;
    int32_t h = c->read_h[i], v = c->read_v[i];
    return snprintf(out, cap, "%s\t%s\t%d\t%d\t%lld\t%lld\n",
        c->name_buf + c->name_offs[v], c->name_buf + c->name_offs[h],
        c->count[i], c->ov[i], (long long)c->lens[v], (long long)c->lens[h]);
}

// Bulk M4 writer: formats rows
//   nameV \t nameH \t count \t score \t ov \t strand \t begV \t endV \t
//   lenV \t begH \t endH \t lenH\n
// names: '\0'-joined buffer + offsets (as produced by fastq_parse).
// Returns bytes written or -1.
int64_t write_m4(const char* path, int append, int64_t nrows,
                 const int32_t* read_h, const int32_t* read_v,
                 const int32_t* count, const int32_t* score,
                 const int64_t* ov, const uint8_t* strand_rc,
                 const int32_t* beg_v, const int32_t* end_v,
                 const int32_t* beg_h, const int32_t* end_h,
                 const char* name_buf, const int64_t* name_offs,
                 const int64_t* lens) {
    M4Ctx ctx = {read_h, read_v, count, score, ov, strand_rc,
                 beg_v, end_v, beg_h, end_h, name_buf, name_offs, lens};
    return write_rows_parallel(path, append, nrows, fmt_m4, &ctx);
}

// Bulk PAF writer (include/overlap.hpp:476-489 row format):
//   nameV lenV begV endV strand nameH lenH begH endH score ov 255
// For '-' strand the H coordinates flip to original coordinates
// (toOriginalCoordinates, include/overlap.hpp:149-154).
int64_t write_paf(const char* path, int append, int64_t nrows,
                  const int32_t* read_h, const int32_t* read_v,
                  const int32_t* score, const int64_t* ov,
                  const uint8_t* strand_rc,
                  const int32_t* beg_v, const int32_t* end_v,
                  const int32_t* beg_h, const int32_t* end_h,
                  const char* name_buf, const int64_t* name_offs,
                  const int64_t* lens) {
    PafCtx ctx = {read_h, read_v, score, ov, strand_rc,
                  beg_v, end_v, beg_h, end_h, name_buf, name_offs, lens};
    return write_rows_parallel(path, append, nrows, fmt_paf, &ctx);
}

// Bulk overlap-only writer: nameV nameH count ov lenV lenH
int64_t write_overlap(const char* path, int append, int64_t nrows,
                      const int32_t* read_h, const int32_t* read_v,
                      const int32_t* count, const int32_t* ov,
                      const char* name_buf, const int64_t* name_offs,
                      const int64_t* lens) {
    OvCtx ctx = {read_h, read_v, count, ov, name_buf, name_offs, lens};
    return write_rows_parallel(path, append, nrows, fmt_overlap, &ctx);
}

}  // extern "C"
