// EVT3 (Prophesee Gen4 / IMX636, Metavision) raw event-stream decoder —
// first-party native host IO.
//
// EVT3 is a STATEFUL little-endian 16-bit word stream (unlike EVT2's
// one-event-per-word): row, time and vector-base registers persist
// across words.  type = word[15:12]:
//
//   0x0  EVT_ADDR_Y    [10:0] y (sensor ROW) -> row register
//                      (bit 11 = camera orig/master flag, ignored)
//   0x2  EVT_ADDR_X    [10:0] x (sensor COLUMN), bit 11 = polarity
//                      -> emit ONE event at (x, row, time)
//   0x3  VECT_BASE_X   [10:0] x base, bit 11 = polarity -> vector regs
//   0x4  VECT_12       [11:0] validity mask -> emit an event at
//                      (base+i, row, time) for every set bit i; base += 12
//   0x5  VECT_8        [7:0] validity mask -> same for 8 bits; base += 8
//   0x6  EVT_TIME_LOW  [11:0] -> time_low register
//   0x8  EVT_TIME_HIGH [11:0] -> time_high register; a time_high that
//                      goes BACKWARD signals a 24-bit rollover -> epoch+1
//   0xA  EXT_TRIGGER   skipped
//   else (0x1 reserved; CONTINUED_4 0x7; OTHERS 0xE; CONTINUED_12 0xF) skipped
//
// Type codes per the Metavision EVT3 spec (openeb event type enum);
// 0x1 is RESERVED — an earlier draft of this decoder had the four
// event-carrying types off by one.
//
//   full timestamp µs = (epoch << 24) | (time_high << 12) | time_low
//
// The plain version, data/evt3.py's decode_evt3_numpy, reconstructs the
// same register state with vectorized forward-fills and segmented
// cumulative sums and gives the same bytes (tests/test_torch_native.py).
//
// Outputs sized by the caller to an upper bound of the events (native's
// typed pre-pass counts them); returns the number written.

#include <cstdint>

extern "C" int64_t evf_decode_evt3(
    const uint16_t* words, int64_t n_words,
    double* x_col, double* y_row, double* t_us, double* pol) {
  if (!words || n_words < 0 || !x_col || !y_row || !t_us || !pol) return -1;
  uint64_t epoch = 0, time_high = 0, time_low = 0;
  uint32_t row = 0, base_x = 0, vect_pol = 0;
  int64_t n_out = 0;
  for (int64_t i = 0; i < n_words; ++i) {
    const uint16_t w = words[i];
    const uint16_t type = w >> 12;
    switch (type) {
      case 0x0:  // EVT_ADDR_Y
        row = w & 0x7FFu;
        break;
      case 0x2: {  // EVT_ADDR_X: single event
        x_col[n_out] = static_cast<double>(w & 0x7FFu);
        y_row[n_out] = static_cast<double>(row);
        t_us[n_out] = static_cast<double>((epoch << 24) | (time_high << 12) | time_low);
        pol[n_out] = static_cast<double>((w >> 11) & 1u);
        ++n_out;
        break;
      }
      case 0x3:  // VECT_BASE_X
        base_x = w & 0x7FFu;
        vect_pol = (w >> 11) & 1u;
        break;
      case 0x4:    // VECT_12
      case 0x5: {  // VECT_8
        const int nbits = (type == 0x4) ? 12 : 8;
        const uint16_t mask = w & ((1u << nbits) - 1u);
        const double t = static_cast<double>((epoch << 24) | (time_high << 12) | time_low);
        for (int b = 0; b < nbits; ++b) {
          if (mask & (1u << b)) {
            x_col[n_out] = static_cast<double>(base_x + b);
            y_row[n_out] = static_cast<double>(row);
            t_us[n_out] = t;
            pol[n_out] = static_cast<double>(vect_pol);
            ++n_out;
          }
        }
        base_x += nbits;
        break;
      }
      case 0x6:  // EVT_TIME_LOW
        time_low = w & 0xFFFu;
        break;
      case 0x8: {  // EVT_TIME_HIGH (+ 24-bit rollover detection)
        const uint64_t th = w & 0xFFFu;
        if (th < time_high) ++epoch;
        time_high = th;
        break;
      }
      default:
        break;  // EXT_TRIGGER / OTHERS / CONTINUED: skipped
    }
  }
  return n_out;
}
