// EVT2 (Prophesee) raw event-stream decoder — first-party native host IO.
//
// The EVT2.0 encoding packs one event per little-endian 32-bit word:
//
//   type = word[31:28]
//   0x0  CD_OFF (polarity 0) \  [27:22] ts_lsb: 6 low bits of the µs
//   0x1  CD_ON  (polarity 1) /  timestamp; [21:11] x (11-bit sensor
//                               COLUMN); [10:0] y (11-bit sensor ROW)
//   0x8  EVT_TIME_HIGH          [27:0] high 28 bits of the µs timestamp
//   0xA  EXT_TRIGGER            skipped
//   else (OTHERS/CONTINUED...)  skipped
//
//   full timestamp µs = (time_high << 6) | ts_lsb
//
// The decoder is a single sequential pass (time_high is stateful), which
// is why it lives here rather than in vectorized numpy.  The plain version,
// data/evt2.py's decode_evt2_numpy, reconstructs the same state with a
// searchsorted forward-fill and gives the same bytes (tests/test_torch_native.py).
//
// Outputs are float64 arrays sized by the caller to n_words (an upper
// bound on the CD-event count); returns the number of events written.

#include <cstdint>

extern "C" int64_t evf_decode_evt2(
    const uint32_t* words, int64_t n_words,
    double* x_col, double* y_row, double* t_us, double* pol) {
  if (!words || n_words < 0 || !x_col || !y_row || !t_us || !pol) return -1;
  uint64_t time_high = 0;
  int64_t n_out = 0;
  for (int64_t i = 0; i < n_words; ++i) {
    const uint32_t w = words[i];
    const uint32_t type = w >> 28;
    if (type <= 1u) {  // CD_OFF / CD_ON
      const uint64_t ts6 = (w >> 22) & 0x3Fu;
      x_col[n_out] = static_cast<double>((w >> 11) & 0x7FFu);
      y_row[n_out] = static_cast<double>(w & 0x7FFu);
      t_us[n_out] = static_cast<double>((time_high << 6) | ts6);
      pol[n_out] = static_cast<double>(type);
      ++n_out;
    } else if (type == 0x8u) {  // EVT_TIME_HIGH
      time_high = w & 0x0FFFFFFFu;
    }
    // EXT_TRIGGER / OTHERS / CONTINUED: skipped
  }
  return n_out;
}
