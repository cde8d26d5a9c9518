// Native FASTQ/FASTA batch reader for midas_tpu.
//
// Role: the hot host-side loop of the whole framework. The reference
// pipes reads through a Python subprocess into C aligners
// (midas/run/stream_seqs.py:43-65 | hs-blastn, species.py:29-49); in
// midas_tpu the aligner is the accelerator, so the only host work per
// batch is parse + 2-bit encode — which in pure Python is far slower
// than the device. This parser fills the caller's preallocated numpy
// buffers directly.
//
// Grammar: lh3-readfq equivalent (multi-line FASTA, 4-line or
// multi-line FASTQ, qual=None -> phred 40 fill), matching
// midas_tpu/io/seqio.py::read_fastx, which mirrors the reference's
// embedded readfq (midas/run/stream_seqs.py:10-41). Truncated final
// FASTQ records degrade to qual-less reads exactly like readfq.
//
// gz/plain transparency via zlib gzopen (which reads uncompressed
// files too). bz2 stays on the Python fallback path.
//
// C ABI (ctypes):
//   void*  mio_open(const char* path, int read_length, long max_reads)
//   long   mio_next_batch(void* h, long B, long L,
//                         int8_t* codes, int8_t* quals,
//                         int32_t* lengths, float* mean_qual,
//                         char* names, long names_cap, int32_t* status)
//          -> reads written; -1 = error (bad handle or corrupt gzip
//             stream); -2 = a single name exceeds names_cap (the parsed
//             record is held pending — grow the buffer and retry).
//          status: 0 = batch filled, 1 = stream exhausted (EOF or
//          max_reads), 2 = stopped early because names filled up (a
//          parsed record is held pending for the next call).
//          names: '\n'-separated, no trailing separator
//   void   mio_close(void* h)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

constexpr int8_t PAD_CODE = 4;

struct LineReader {
  gzFile f = nullptr;
  std::vector<char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  bool err = false;  // corrupt/truncated gzip stream (gzread < 0)

  explicit LineReader(const char* path) : buf(1 << 20) {
    f = gzopen(path, "rb");
  }
  ~LineReader() {
    if (f) gzclose(f);
  }
  bool ok() const { return f != nullptr; }

  bool fill() {
    if (eof) return false;
    int n = gzread(f, buf.data(), (unsigned)buf.size());
    if (n <= 0) {
      if (n < 0) {
        int zerrno = 0;
        gzerror(f, &zerrno);
        err = true;  // real stream error, not EOF — propagate, don't truncate
      }
      eof = true;
      return false;
    }
    pos = 0;
    len = (size_t)n;
    return true;
  }

  // Append the next line (without '\n'; a trailing '\r' is stripped so
  // CRLF input matches the text-mode universal-newline Python parsers)
  // to out. Returns false at EOF with nothing read.
  bool getline(std::string& out) {
    out.clear();
    bool any = false;
    for (;;) {
      if (pos >= len && !fill()) {
        if (any && !out.empty() && out.back() == '\r') out.pop_back();
        return any;
      }
      char* start = buf.data() + pos;
      char* nl = (char*)memchr(start, '\n', len - pos);
      if (nl) {
        out.append(start, nl - start);
        pos = (size_t)(nl - buf.data()) + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(start, len - pos);
      pos = len;
      any = true;
    }
  }
};

struct Reader {
  LineReader lr;
  int read_length;   // 0 = no trim/drop
  long max_reads;    // <0 = unlimited
  long emitted = 0;
  long truncated = 0;  // reads longer than the batch width L
  std::string last;  // pending header line ('>'/'@' line), empty if none
  std::string line, seq, qual;
  // record parsed but not yet emitted (names buffer was full)
  bool has_pending = false;
  std::string p_name, p_seq, p_qual;
  bool p_has_qual = false;

  Reader(const char* path, int rl, long mr)
      : lr(path), read_length(rl), max_reads(mr) {}

  // readfq step: parse one record. Returns false at stream end.
  bool next(std::string& name, std::string& s, std::string& q,
            bool& has_qual) {
    if (last.empty()) {
      while (lr.getline(line)) {
        if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
          last = line;
          break;
        }
      }
      if (last.empty()) return false;
    }
    size_t sp = last.find(' ');
    name.assign(last, 1, sp == std::string::npos ? std::string::npos : sp - 1);
    s.clear();
    last.clear();
    bool have_last = false;
    while (lr.getline(line)) {
      if (!line.empty() &&
          (line[0] == '@' || line[0] == '+' || line[0] == '>')) {
        last = line;
        have_last = true;
        break;
      }
      s += line;
    }
    if (!have_last || last[0] != '+') {
      has_qual = false;  // FASTA (or trailing header-less EOF)
      return true;
    }
    // FASTQ quality lines until length matches
    last.clear();
    q.clear();
    while (q.size() < s.size() && lr.getline(line)) q += line;
    if (q.size() >= s.size()) {
      has_qual = true;
      q.resize(s.size());
    } else {
      has_qual = false;  // truncated record: degrade like readfq
    }
    return true;
  }
};

int8_t g_base_code[256];
struct InitTables {
  InitTables() {
    memset(g_base_code, PAD_CODE, sizeof(g_base_code));
    const char* b = "ACGT";
    for (int i = 0; i < 4; i++) {
      g_base_code[(unsigned char)b[i]] = (int8_t)i;
      g_base_code[(unsigned char)(b[i] + 32)] = (int8_t)i;
    }
  }
} g_init_tables;

}  // namespace

extern "C" {

long mio_truncated(void* h) {
  Reader* r = (Reader*)h;
  return r ? r->truncated : 0;
}

void* mio_open(const char* path, int read_length, long max_reads) {
  Reader* r = new Reader(path, read_length, max_reads);
  if (!r->lr.ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

long mio_next_batch(void* h, long B, long L, int8_t* codes, int8_t* quals,
                    int32_t* lengths, float* mean_qual, char* names,
                    long names_cap, int32_t* status) {
  Reader* r = (Reader*)h;
  if (!r) return -1;
  *status = 0;
  memset(codes, PAD_CODE, (size_t)(B * L));
  memset(quals, 0, (size_t)(B * L));
  memset(lengths, 0, (size_t)B * sizeof(int32_t));
  memset(mean_qual, 0, (size_t)B * sizeof(float));
  long nb = 0, npos = 0;
  std::string name, s, q;
  bool has_qual;
  while (nb < B) {
    if (r->has_pending) {
      name.swap(r->p_name);
      s.swap(r->p_seq);
      q.swap(r->p_qual);
      has_qual = r->p_has_qual;
      r->has_pending = false;
    } else {
      if (r->max_reads >= 0 && r->emitted >= r->max_reads) {
        *status = 1;
        break;
      }
      if (!r->next(name, s, q, has_qual)) {
        if (r->lr.err) return -1;  // corrupt gzip stream, not EOF
        *status = 1;
        break;
      }
      if (r->read_length > 0) {
        if ((long)s.size() < (long)r->read_length) continue;
        s.resize(r->read_length);
        if (has_qual) q.resize(r->read_length);
      }
    }
    if (npos + (long)name.size() + 1 > names_cap) {
      // The record has already been consumed from the stream — stash it
      // so it is emitted on the retry / next call instead of dropped.
      r->p_name.swap(name);
      r->p_seq.swap(s);
      r->p_qual.swap(q);
      r->p_has_qual = has_qual;
      r->has_pending = true;
      if (nb == 0) return -2;  // caller must grow the names buffer
      *status = 2;
      break;
    }
    long n = (long)s.size();
    if (n > L) { n = L; r->truncated++; }
    int8_t* crow = codes + nb * L;
    for (long i = 0; i < n; i++)
      crow[i] = g_base_code[(unsigned char)s[i]];
    int8_t* qrow = quals + nb * L;
    long qsum = 0;
    if (has_qual) {
      for (long i = 0; i < n; i++) {
        int v = (unsigned char)q[i] - 33;
        qrow[i] = (int8_t)v;
        qsum += v;
      }
    } else {
      memset(qrow, 40, (size_t)n);
      qsum = 40 * n;
    }
    lengths[nb] = (int32_t)n;
    mean_qual[nb] = n ? (float)qsum / (float)n : 0.0f;
    memcpy(names + npos, name.data(), name.size());
    npos += (long)name.size();
    names[npos++] = '\n';
    nb++;
    r->emitted++;
  }
  if (npos > 0) names[npos - 1] = '\0';
  else if (names_cap > 0) names[0] = '\0';
  return nb;
}

void mio_close(void* h) { delete (Reader*)h; }

// Scan an ENTIRE file for its longest read — the padded-batch bucket
// must cover the longest read in the library, and sampling only the
// file head silently truncated libraries whose long reads appear later
// (mixed-length or length-sorted input). A dedicated scan loop (no
// array fills) runs at several million reads/s, so a full pass costs
// seconds even on 10M-read files. Returns the max length (0 for an
// empty file), -1 on open failure.
long mio_max_read_len(const char* path) {
  Reader r(path, 0, -1);
  if (!r.lr.ok()) return -1;
  std::string name, s, q;
  bool hq;
  long mx = 0;
  while (r.next(name, s, q, hq)) {
    if ((long)s.size() > mx) mx = (long)s.size();
  }
  if (r.lr.err) return -1;
  return mx;
}

}  // extern "C"
