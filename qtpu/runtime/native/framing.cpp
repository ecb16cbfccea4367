// framing.cpp — native raw-event codec and epoch splitter for qtpu.
//
// Reference capability: the chopper/chopper2 ingest path
// (remotecrypto/chopper.c, SURVEY.md §3 #3-4, Appendix A): hardware emits
// 64-bit raw event records — 49-bit timestamp in 125 ps units + 4-bit
// detector id — which the choppers split into epoch-addressed streams.
// The framework keeps events in arrays; this library is the fast host-side
// codec for recorded event files and the epoch boundary scan, so ingest of
// multi-GB recordings never bottlenecks in Python.
//
// Record layout (little-endian u64): bits [52:4] = time, bits [3:0] = detector.
//
// C API:
//   fr_pack_events(times i64[n], dets u8[n], n, out u64[n])
//   fr_unpack_events(recs u64[n], n, times i64[n], dets u8[n])
//   fr_split_epochs(times i64[n] sorted, n, units_per_epoch,
//                   epoch_ids u32[max_out], starts i64[max_out],
//                   counts i64[max_out], max_out) -> epochs found (or -1)
//   fr_pack_bits(bits u8[n], n, words u32[ceil(n/32)])   (LSB-first)

#include <cstdint>
#include <cstring>

namespace {
constexpr uint64_t kTimeMask = (1ULL << 49) - 1;
}

extern "C" {

void fr_pack_events(const int64_t* times, const uint8_t* dets, int64_t n,
                    uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = ((static_cast<uint64_t>(times[i]) & kTimeMask) << 4) |
             (dets[i] & 0xF);
  }
}

void fr_unpack_events(const uint64_t* recs, int64_t n, int64_t* times,
                      uint8_t* dets) {
  for (int64_t i = 0; i < n; i++) {
    times[i] = static_cast<int64_t>((recs[i] >> 4) & kTimeMask);
    dets[i] = static_cast<uint8_t>(recs[i] & 0xF);
  }
}

int64_t fr_split_epochs(const int64_t* times, int64_t n,
                        int64_t units_per_epoch, uint32_t* epoch_ids,
                        int64_t* starts, int64_t* counts, int64_t max_out) {
  if (n == 0) return 0;
  int64_t out = 0;
  int64_t cur_epoch = times[0] / units_per_epoch;
  int64_t start = 0;
  for (int64_t i = 1; i <= n; i++) {
    int64_t e = (i < n) ? times[i] / units_per_epoch : -1;
    if (i == n || e != cur_epoch) {
      if (out >= max_out) return -1;
      epoch_ids[out] = static_cast<uint32_t>(cur_epoch);
      starts[out] = start;
      counts[out] = i - start;
      out++;
      cur_epoch = e;
      start = i;
    }
  }
  return out;
}

void fr_pack_bits(const uint8_t* bits, int64_t n, uint32_t* words) {
  int64_t nw = (n + 31) / 32;
  std::memset(words, 0, static_cast<size_t>(nw) * 4);
  for (int64_t i = 0; i < n; i++) {
    words[i >> 5] |= static_cast<uint32_t>(bits[i] & 1) << (i & 31);
  }
}

}  // extern "C"
