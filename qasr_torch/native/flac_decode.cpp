// Native FLAC decoder for the LibriSpeech data loader (SURVEY.md §2a C10
// analogue for configs 4-5; the reference family reads corpora with
// soundfile/HTK tooling — this container has none, so the loader ships its
// own). Scope: the FLAC subset LibriSpeech uses and a bit more — 8/16/24-bit
// PCM, 1-2 channels, all subframe types (constant / verbatim / fixed 0-4 /
// LPC 1-32), rice residual partitions incl. escape codes, left/right/mid-side
// stereo decorrelation, UTF-8 frame numbers. Frame-header CRC-8 is verified
// (resync safety); MD5 is not.
//
// Exposed C ABI (ctypes):
//   qasr_flac_probe(path, *n_samples, *channels, *sample_rate, *bps) -> 0 ok
//   qasr_flac_decode(path, out, capacity) -> samples written per channel,
//     interleaved int32, or -1 on error (message via qasr_flac_error()).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7)

  bool eof() const { return byte >= size; }
  size_t bits_left() const { return (size - byte) * 8 - bit; }

  // read up to 32 bits MSB-first
  uint32_t read(int n) {
    uint32_t v = 0;
    while (n > 0) {
      if (byte >= size) throw std::string("unexpected EOF in bitstream");
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      uint32_t chunk = (data[byte] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit += take;
      if (bit == 8) { bit = 0; ++byte; }
      n -= take;
    }
    return v;
  }

  uint64_t read64(int n) {
    uint64_t v = 0;
    if (n > 32) { v = read(n - 32); n = 32; }
    return (v << n) | read(n);
  }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read64(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (read(1) == 0) ++q;
    return q;
  }

  void align() {
    if (bit) { bit = 0; ++byte; }
  }
};

uint8_t crc8(const uint8_t* data, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= data[i];
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { g_error = std::string("cannot open ") + path; return false; }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize((size_t)n);
  size_t got = n ? std::fread(buf.data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  if (got != (size_t)n) { g_error = "short read"; return false; }
  return true;
}

bool parse_header(BitReader& br, StreamInfo& si) {
  if (br.size < 4 || std::memcmp(br.data, "fLaC", 4) != 0) {
    g_error = "not a FLAC stream (missing fLaC magic)";
    return false;
  }
  br.byte = 4;
  bool last = false;
  bool have_info = false;
  while (!last) {
    uint32_t hdr = br.read(8);
    last = hdr & 0x80;
    uint32_t type = hdr & 0x7f;
    uint32_t len = br.read(24);
    if (type == 0) {  // STREAMINFO
      br.read(16); br.read(16);      // min/max blocksize
      br.read(24); br.read(24);      // min/max framesize
      si.sample_rate = br.read(20);
      si.channels = (int)br.read(3) + 1;
      si.bps = (int)br.read(5) + 1;
      si.total_samples = br.read64(36);
      for (int i = 0; i < 16; ++i) br.read(8);  // md5
      have_info = true;
    } else {
      for (uint32_t i = 0; i < len; ++i) br.read(8);
    }
  }
  if (!have_info) { g_error = "missing STREAMINFO"; return false; }
  return true;
}

// decode one frame; append samples (interleaved) to out. Returns samples per
// channel, or 0 at clean EOF.
size_t decode_frame(BitReader& br, const StreamInfo& si,
                    std::vector<int32_t>& out) {
  // skip any padding bytes at EOF
  if (br.bits_left() < 32) return 0;
  size_t hdr_start = br.byte;
  uint32_t sync = br.read(14);
  if (sync != 0x3ffe) throw std::string("lost frame sync");
  br.read(1);                       // reserved
  br.read(1);                       // blocking strategy
  uint32_t bs_code = br.read(4);
  uint32_t sr_code = br.read(4);
  uint32_t ch_code = br.read(4);
  uint32_t ss_code = br.read(3);
  br.read(1);                       // reserved

  // UTF-8 coded frame/sample number (up to 7 bytes)
  uint32_t first = br.read(8);
  int follow = 0;
  for (uint32_t m = 0x80; first & m; m >>= 1) ++follow;
  if (follow) --follow;  // first 1-bit counts itself
  for (int i = 0; i < follow; ++i) br.read(8);

  uint32_t blocksize;
  switch (bs_code) {
    case 1: blocksize = 192; break;
    case 2: case 3: case 4: case 5:
      blocksize = 576u << (bs_code - 2); break;
    case 6: blocksize = br.read(8) + 1; break;
    case 7: blocksize = br.read(16) + 1; break;
    default:
      if (bs_code >= 8 && bs_code <= 15) blocksize = 256u << (bs_code - 8);
      else throw std::string("reserved blocksize code");
  }
  if (sr_code == 12) br.read(8);
  else if (sr_code == 13 || sr_code == 14) br.read(16);

  int bps = si.bps;
  switch (ss_code) {
    case 0: break;                  // from STREAMINFO
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: throw std::string("reserved sample size code");
  }

  // CRC-8 over the header bytes (ends on a byte boundary here)
  uint8_t expect = (uint8_t)br.read(8);
  if (crc8(br.data + hdr_start, br.byte - 1 - hdr_start) != expect)
    throw std::string("frame header CRC-8 mismatch");

  int channels;
  enum { INDEP, LEFT_SIDE, RIGHT_SIDE, MID_SIDE } mode = INDEP;
  if (ch_code < 8) {
    channels = (int)ch_code + 1;
  } else if (ch_code == 8) { channels = 2; mode = LEFT_SIDE; }
  else if (ch_code == 9) { channels = 2; mode = RIGHT_SIDE; }
  else if (ch_code == 10) { channels = 2; mode = MID_SIDE; }
  else throw std::string("reserved channel assignment");
  if (channels != si.channels)
    throw std::string("frame/stream channel count mismatch");

  std::vector<std::vector<int64_t>> ch(channels);
  for (int c = 0; c < channels; ++c) {
    int sbps = bps;
    if ((mode == LEFT_SIDE && c == 1) || (mode == RIGHT_SIDE && c == 0) ||
        (mode == MID_SIDE && c == 1))
      sbps += 1;  // side channel carries one extra bit

    if (br.read(1) != 0) throw std::string("invalid subframe padding bit");
    uint32_t type = br.read(6);
    int wasted = 0;
    if (br.read(1)) wasted = (int)br.read_unary() + 1;
    sbps -= wasted;

    std::vector<int64_t>& s = ch[c];
    s.assign(blocksize, 0);

    auto read_residual = [&](int order) {
      uint32_t method = br.read(2);
      if (method > 1) throw std::string("reserved residual method");
      int plen = method == 0 ? 4 : 5;
      uint32_t escape = method == 0 ? 0xF : 0x1F;
      uint32_t porder = br.read(4);
      uint32_t nparts = 1u << porder;
      size_t idx = (size_t)order;
      for (uint32_t p = 0; p < nparts; ++p) {
        size_t count = blocksize >> porder;
        if (p == 0) count -= order;
        uint32_t param = br.read(plen);
        if (param == escape) {
          uint32_t raw = br.read(5);
          for (size_t i = 0; i < count; ++i) s[idx++] = br.read_signed(raw);
        } else {
          for (size_t i = 0; i < count; ++i) {
            uint32_t q = br.read_unary();
            uint32_t r = param ? br.read((int)param) : 0;
            uint32_t v = (q << param) | r;
            s[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
          }
        }
      }
    };

    if (type == 0) {  // constant
      int64_t v = br.read_signed(sbps);
      for (uint32_t i = 0; i < blocksize; ++i) s[i] = v;
    } else if (type == 1) {  // verbatim
      for (uint32_t i = 0; i < blocksize; ++i) s[i] = br.read_signed(sbps);
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // fixed
      int order = type & 0x07;
      for (int i = 0; i < order; ++i) s[i] = br.read_signed(sbps);
      read_residual(order);
      for (uint32_t i = order; i < blocksize; ++i) {
        switch (order) {
          case 0: break;
          case 1: s[i] += s[i - 1]; break;
          case 2: s[i] += 2 * s[i - 1] - s[i - 2]; break;
          case 3: s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
          case 4:
            s[i] += 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4];
            break;
        }
      }
    } else if (type & 0x20) {  // LPC
      int order = (int)(type & 0x1f) + 1;
      for (int i = 0; i < order; ++i) s[i] = br.read_signed(sbps);
      int precision = (int)br.read(4) + 1;
      if (precision == 16) throw std::string("invalid LPC precision");
      int shift = (int)br.read_signed(5);
      if (shift < 0) throw std::string("negative LPC shift");
      std::vector<int64_t> coef(order);
      for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
      read_residual(order);
      for (uint32_t i = order; i < blocksize; ++i) {
        int64_t pred = 0;
        for (int j = 0; j < order; ++j) pred += coef[j] * s[i - 1 - j];
        s[i] += pred >> shift;
      }
    } else {
      throw std::string("reserved subframe type");
    }
    if (wasted)
      for (uint32_t i = 0; i < blocksize; ++i) s[i] <<= wasted;
  }

  br.align();
  br.read(16);  // frame CRC-16 (not verified; header CRC already was)

  // inter-channel decorrelation
  if (mode == LEFT_SIDE) {
    for (uint32_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
  } else if (mode == RIGHT_SIDE) {
    for (uint32_t i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
  } else if (mode == MID_SIDE) {
    for (uint32_t i = 0; i < blocksize; ++i) {
      int64_t side = ch[1][i];
      int64_t mid = (ch[0][i] << 1) | (side & 1);
      ch[0][i] = (mid + side) >> 1;
      ch[1][i] = (mid - side) >> 1;
    }
  }

  for (uint32_t i = 0; i < blocksize; ++i)
    for (int c = 0; c < channels; ++c) out.push_back((int32_t)ch[c][i]);
  return blocksize;
}

}  // namespace

extern "C" {

const char* qasr_flac_error() { return g_error.c_str(); }

int qasr_flac_probe(const char* path, int64_t* n_samples, int32_t* channels,
                    int32_t* sample_rate, int32_t* bps) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  BitReader br{buf.data(), buf.size()};
  StreamInfo si;
  try {
    if (!parse_header(br, si)) return -1;
  } catch (const std::string& e) {
    g_error = e;
    return -1;
  }
  *n_samples = (int64_t)si.total_samples;
  *channels = si.channels;
  *sample_rate = (int32_t)si.sample_rate;
  *bps = si.bps;
  return 0;
}

// out: caller-allocated int32 buffer of capacity total interleaved samples.
// Returns samples-per-channel decoded, or -1 on error.
int64_t qasr_flac_decode(const char* path, int32_t* out_buf, int64_t capacity) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return -1;
  BitReader br{buf.data(), buf.size()};
  StreamInfo si;
  std::vector<int32_t> out;
  try {
    if (!parse_header(br, si)) return -1;
    out.reserve((size_t)(si.total_samples * si.channels));
    while (true) {
      size_t got = decode_frame(br, si, out);
      if (got == 0) break;
      if (si.total_samples &&
          out.size() >= (size_t)(si.total_samples * si.channels))
        break;
    }
  } catch (const std::string& e) {
    g_error = e;
    return -1;
  }
  if ((int64_t)out.size() > capacity) {
    g_error = "output buffer too small";
    return -1;
  }
  std::memcpy(out_buf, out.data(), out.size() * sizeof(int32_t));
  return (int64_t)(out.size() / (size_t)si.channels);
}

}  // extern "C"
