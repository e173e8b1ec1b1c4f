/* qm2core — native runtime helpers for quickmer2.
 *
 * The device compute path (codec, probe, scatter-add, edit-distance
 * filter) lives in JAX; this library covers the host-side runtime work the
 * reference does in C (QuicKmer.c) and that pure Python cannot do at
 * speed: pointer-chasing the genome-order chain, order-dependent hash
 * placement for .qm export, bulk lookups for host-side verification, and
 * a streaming FASTA/FASTQ parser that packs reads into 2-bit code
 * streams for device batches.
 *
 * Fresh implementation; behavioral parity targets are documented per
 * function against the reference QuicKmer.c (cited file:line).
 *
 * Build: gcc -O3 -march=native -shared -fPIC -o libqm2core.so qm2core.c
 */

#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* DJB2 over the 8 LE bytes of a u64 code (parity: QuicKmer.c:66-76). */
static inline uint64_t djb2_u64(uint64_t kmer) {
    uint64_t h = 5381;
    for (int i = 0; i < 8; i++) {
        h = h * 33 + (kmer & 0xFF);
        kmer >>= 8;
    }
    return h;
}

/* Bidirectional linear probe (parity: QuicKmer.c:90-99).
 * Returns the terminal slot; *hit = 1 iff table[slot] == key. */
static inline uint64_t probe_slot(const uint64_t *table, uint64_t hsize,
                                  uint64_t key, int *hit) {
    uint64_t idx = djb2_u64(key) & (hsize - 1);
    int64_t step = (idx & (hsize >> 1)) ? -1 : 1;
    while (table[idx] && table[idx] != key)
        idx += step;
    *hit = (table[idx] == key);
    return idx;
}


/* Sliding canonical k-mers of a code stream (host bulk kmerize).
 * codes: u8[n_codes] (0..3 bases, >=4 separator); writes, per window i
 * in [0, n_codes-k+1): canon[i] = min(fwd, rc) (exact rc for all k —
 * unlike the reference's fixed <<60 shift, QuicKmer.c:43-64/SURVEY Q1),
 * flags[i] bit0 = window valid (no separator), bit1 = canonical is the
 * forward strand (fwd <= rc). ~10x the numpy rolling loop. */
void qm2_sliding_canon(const uint8_t *codes, int64_t n_codes, int32_t k,
                       uint64_t *canon, uint8_t *flags) {
    int64_t n = n_codes - k + 1;
    if (n <= 0) return;
    uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    int top = 2 * (k - 1);
    uint64_t fwd = 0, rc = 0;
    int64_t bad = 0;               /* windows until last SEP clears */
    for (int64_t i = 0; i < n_codes; i++) {
        uint64_t c = codes[i];
        if (c >= 4) {
            bad = k;
            c = 0;
        } else if (bad > 0) {
            bad--;
        }
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | (((c - 2) & 3ULL) << top);
        int64_t w = i - k + 1;
        if (w >= 0) {
            uint64_t cn = fwd <= rc ? fwd : rc;
            canon[w] = cn;
            flags[w] = (uint8_t)(((bad == 0) ? 1 : 0)
                                 | ((fwd <= rc) ? 2 : 0));
        }
    }
}

/* Walk the circular chain from `first`, writing slot order to out.
 * Stops after cap entries or when the walk returns to first.
 * Returns the number of slots written. (Parity: QuicKmer.c:494-516.) */
int64_t qm2_chain_walk(const uint32_t *chain, uint64_t first,
                       int64_t *out, int64_t cap) {
    uint64_t idx = first;
    int64_t n = 0;
    while (n < cap) {
        out[n++] = (int64_t)idx;
        idx = chain[idx];
        if (idx == first) break;
    }
    return n;
}

/* Insert keys in order into an open-addressing table (0 = empty).
 * slots_out (optional) receives the placement of each key.
 * Duplicate keys resolve to their existing slot. */
void qm2_insert_keys(uint64_t *table, uint64_t hsize,
                     const uint64_t *keys, int64_t n, int64_t *slots_out) {
    for (int64_t i = 0; i < n; i++) {
        int hit;
        uint64_t slot = probe_slot(table, hsize, keys[i], &hit);
        table[slot] = keys[i];
        if (slots_out) slots_out[i] = (int64_t)slot;
    }
}

/* Bulk lookup. found[i]=1 when the scan ended on a matching slot (a key
 * of 0 "finds" the first empty slot — quirk Q3, SURVEY.md). */
void qm2_lookup_keys(const uint64_t *table, uint64_t hsize,
                     const uint64_t *keys, int64_t n,
                     int64_t *slots, uint8_t *found) {
    for (int64_t i = 0; i < n; i++) {
        int hit;
        slots[i] = (int64_t)probe_slot(table, hsize, keys[i], &hit);
        found[i] = (uint8_t)hit;
    }
}

/* Tabulate occurrence counts (saturating at 255 — QuicKmer.c:888) for a
 * stream of canonical codes against a table that already contains every
 * distinct key. Used by the host-side search fallback. */
void qm2_count_occr(const uint64_t *table, uint64_t hsize,
                    const uint64_t *keys, int64_t n, uint8_t *occr) {
    for (int64_t i = 0; i < n; i++) {
        int hit;
        uint64_t slot = probe_slot(table, hsize, keys[i], &hit);
        if (hit && occr[slot] < 255) occr[slot]++;
    }
}

/* Sequential thinning for `sparse`: keep[i]=1 iff bp[i] - last_kept >=
 * thin (parity: QuicKmer.c:1419-1432 — drop when the gap is < thin;
 * last_kept starts at 0 per chromosome, so leading k-mers with
 * bp < thin are dropped). bp values are per-chromosome non-N base
 * counters in ascending order. */
void qm2_thin_hits(const uint32_t *bp, int64_t n, uint32_t thin,
                   uint8_t *keep) {
    uint32_t last = 0;
    for (int64_t i = 0; i < n; i++) {
        if (bp[i] - last < thin) {
            keep[i] = 0;
        } else {
            keep[i] = 1;
            last = bp[i];
        }
    }
}

/* Insert allowing duplicates: always scan to the first empty slot, even
 * past an existing copy of the key (parity: index mode, QuicKmer.c:
 * 208-213 — duplicate bed rows occupy multiple slots). */
void qm2_insert_keys_dup(uint64_t *table, uint64_t hsize,
                         const uint64_t *keys, int64_t n,
                         int64_t *slots_out) {
    for (int64_t i = 0; i < n; i++) {
        uint64_t idx = djb2_u64(keys[i]) & (hsize - 1);
        int64_t step = (idx & (hsize >> 1)) ? -1 : 1;
        while (table[idx])
            idx += step;
        table[idx] = keys[i];
        if (slots_out) slots_out[i] = (int64_t)idx;
    }
}

/* ------------------------------------------------------------------ */
/* Streaming FASTA/FASTQ → 2-bit code stream packer.
 *
 * Emits one uint8 per base: 0..3 for ACGT/acgt ((c>>1)&3, parity with
 * QuicKmer.c:54), 4 for any other sequence byte (N etc.), and exactly one
 * 4 separator at every record/line boundary. Because the count phase
 * treats any window containing a >=4 code as invalid, a separator per
 * line reproduces the reference count's per-line rolling reset
 * (QuicKmer.c:399-402, SURVEY.md Q4).
 *
 * The parser is a byte state machine with persistent state so input may
 * be fed in arbitrary chunks. FASTA mode (fmt=0): '>' header lines are
 * skipped; every sequence LINE ends with a separator (count semantics).
 * FASTA mode (fmt=2): like fmt=0 but sequence state persists across
 * lines within a record (search/dump semantics, QuicKmer.c:826-852) —
 * separators only at headers and N bases.
 * FASTQ mode (fmt=1): '@' header, sequence lines, '+' line, quality
 * lines (skipped; length-tracked so '@' in quality is safe).
 */

typedef struct {
    int32_t mode;       /* 0 fasta-lines, 1 fastq, 2 fasta-record */
    int32_t state;      /* parser state, see enum below */
    int64_t seq_len;    /* bases seen in current record (fastq) */
    int64_t qual_left;  /* quality bytes still to skip (fastq) */
    int32_t emitted_sep;/* last emitted byte was a separator */
} qm2_parse_state;

enum { ST_LINE_START = 0, ST_HEADER = 1, ST_SEQ = 2, ST_PLUS = 3, ST_QUAL = 4 };

static const uint8_t BASE_LUT[256] = {
    ['A'] = 1, ['C'] = 2, ['G'] = 4, ['T'] = 3,  /* +1 so 0 = invalid */
    ['a'] = 1, ['c'] = 2, ['g'] = 4, ['t'] = 3,
};
/* (code stored +1: A=1,C=2,T=3,G=4 → emit value-1; table rows default 0) */

/* branchless direct code table: 0-3 bases, 4 for anything else */
static uint8_t CODE_LUT[256];
__attribute__((constructor)) static void init_code_lut(void) {
    for (int c = 0; c < 256; c++)
        CODE_LUT[c] = BASE_LUT[c] ? (uint8_t)(BASE_LUT[c] - 1) : 4;
}

void qm2_parse_init(qm2_parse_state *st, int32_t mode) {
    memset(st, 0, sizeof(*st));
    st->mode = mode;
    st->state = ST_LINE_START;
    st->emitted_sep = 1;
}

/* Parse `len` input bytes, appending codes to out (capacity out_cap must
 * be >= len + 1). Returns number of codes emitted. */
int64_t qm2_parse_chunk(qm2_parse_state *st, const uint8_t *buf, int64_t len,
                        uint8_t *out) {
    int64_t o = 0;
    int fastq = (st->mode == 1);
    int per_line_sep = (st->mode != 2);
    for (int64_t i = 0; i < len; i++) {
        uint8_t c = buf[i];
        switch (st->state) {
        case ST_LINE_START:
            if (c == '\n') break;
            if (c == '>' || (fastq && c == '@')) {
                st->state = ST_HEADER;
                st->seq_len = 0;
                if (!st->emitted_sep) { out[o++] = 4; st->emitted_sep = 1; }
            } else if (fastq && c == '+') {
                st->state = ST_PLUS;
                st->qual_left = st->seq_len;
            } else {
                st->state = ST_SEQ;
                i--;  /* reprocess this byte in the bulk ST_SEQ path */
            }
            break;
        case ST_HEADER:
            if (c == '\n') st->state = fastq ? ST_SEQ : ST_LINE_START;
            break;
        case ST_SEQ: {
            if (c == '\n') {
                st->state = ST_LINE_START; /* fastq next: more seq, or '+' */
                if (per_line_sep && !st->emitted_sep) {
                    out[o++] = 4; st->emitted_sep = 1;
                }
                break;
            }
            /* bulk path: branchless translate of the whole line (one
             * code per byte; invalid bases emit 4 — adjacent 4s are
             * harmless since any window containing one is invalid) */
            const uint8_t *nl = memchr(buf + i, '\n', len - i);
            int64_t end = nl ? (int64_t)(nl - buf) : len;
            for (int64_t j = i; j < end; j++)
                out[o++] = CODE_LUT[buf[j]];
            if (end > i)
                st->emitted_sep = (CODE_LUT[buf[end - 1]] == 4);
            if (fastq) st->seq_len += end - i;
            i = end - 1;  /* loop increment lands on the newline (or len) */
            break;
        }
        case ST_PLUS:
            if (c == '\n') {
                st->state = ST_QUAL;
                if (!st->emitted_sep) { out[o++] = 4; st->emitted_sep = 1; }
            }
            break;
        case ST_QUAL: {
            /* skip exactly seq_len quality bytes; '@' inside quality is
             * safe because we count bytes, not sentinels. Newlines are
             * not counted toward the quality length. Bulk-skips spans
             * between newlines via memchr. */
            int64_t j = i;
            while (st->qual_left > 0 && j < len) {
                if (buf[j] == '\n') { j++; continue; }
                const uint8_t *nl = memchr(buf + j, '\n', len - j);
                int64_t end = nl ? (int64_t)(nl - buf) : len;
                int64_t take = end - j;
                if (take > st->qual_left) take = st->qual_left;
                st->qual_left -= take;
                j += take;
            }
            i = j - 1;
            if (st->qual_left == 0) { st->state = ST_LINE_START; st->seq_len = 0; }
            break;
        }
        }
    }
    return o;
}
