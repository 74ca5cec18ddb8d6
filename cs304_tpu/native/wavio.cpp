// Native data-loader tier: WAV decode, frame energies, endpointing.
//
// The reference's IO path is scipy.io.wavfile per file plus a pure-Python
// per-frame energy state machine (ti_digits.py:130-134,
// signal_separation.py:102-151). This module is the C++ equivalent feeding
// the device input pipeline: PCM16/PCM32/float32 WAV parsing straight into
// float32 buffers, vectorized per-frame mean-|x| energies, and the same
// high/low hysteresis endpointing automaton. Exposed as a plain C ABI for
// ctypes (no pybind11 in this image).
//
// Build: see cs304_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decoding (RIFF PCM16 / PCM32 / IEEE float32, first channel only)
// ---------------------------------------------------------------------------

// Returns number of samples written, or a negative error code:
//  -1 open failure, -2 not RIFF/WAVE, -3 unsupported format, -4 buffer small,
//  -5 truncated data chunk (header promised more frames than the file holds),
//  -6 out of memory.
long wav_read(const char* path, float* out, long max_len, int* sample_rate) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;

    char riff[4], wave[4];
    uint32_t riff_size;
    if (std::fread(riff, 1, 4, f) != 4 || std::fread(&riff_size, 4, 1, f) != 1 ||
        std::fread(wave, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
        std::memcmp(wave, "WAVE", 4)) {
        std::fclose(f);
        return -2;
    }

    uint16_t audio_format = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    long written = -3;

    char chunk_id[4];
    uint32_t chunk_size;
    while (std::fread(chunk_id, 1, 4, f) == 4 &&
           std::fread(&chunk_size, 4, 1, f) == 1) {
        if (!std::memcmp(chunk_id, "fmt ", 4)) {
            uint16_t block_align;
            uint32_t byte_rate;
            if (std::fread(&audio_format, 2, 1, f) != 1 ||
                std::fread(&channels, 2, 1, f) != 1 ||
                std::fread(&rate, 4, 1, f) != 1 ||
                std::fread(&byte_rate, 4, 1, f) != 1 ||
                std::fread(&block_align, 2, 1, f) != 1 ||
                std::fread(&bits, 2, 1, f) != 1) {
                std::fclose(f);
                return -2;
            }
            if (chunk_size > 16) std::fseek(f, chunk_size - 16, SEEK_CUR);
        } else if (!std::memcmp(chunk_id, "data", 4)) {
            if (channels == 0) { std::fclose(f); return -2; }
            long bytes_per = bits / 8;
            long n_frames = chunk_size / (bytes_per * channels);
            if (n_frames > max_len) { std::fclose(f); return -4; }
            // A short fread means the header promised more frames than the
            // file holds: report -5 instead of returning the full frame
            // count over an uninitialized buffer (advisor finding r1).
            if (audio_format == 1 && bits == 16) {
                int16_t* buf = (int16_t*)std::malloc(chunk_size);
                if (!buf) { std::fclose(f); return -6; }
                written = std::fread(buf, 1, chunk_size, f) == chunk_size
                              ? n_frames : -5;
                for (long i = 0; i < (written > 0 ? written : 0); ++i)
                    out[i] = (float)buf[i * channels];
                std::free(buf);
            } else if (audio_format == 1 && bits == 32) {
                int32_t* buf = (int32_t*)std::malloc(chunk_size);
                if (!buf) { std::fclose(f); return -6; }
                written = std::fread(buf, 1, chunk_size, f) == chunk_size
                              ? n_frames : -5;
                for (long i = 0; i < (written > 0 ? written : 0); ++i)
                    out[i] = (float)buf[i * channels];
                std::free(buf);
            } else if (audio_format == 3 && bits == 32) {
                float* buf = (float*)std::malloc(chunk_size);
                if (!buf) { std::fclose(f); return -6; }
                written = std::fread(buf, 1, chunk_size, f) == chunk_size
                              ? n_frames : -5;
                for (long i = 0; i < (written > 0 ? written : 0); ++i)
                    out[i] = buf[i * channels];
                std::free(buf);
            } else {
                written = -3;
            }
            break;
        } else {
            std::fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
        }
    }
    std::fclose(f);
    if (sample_rate) *sample_rate = (int)rate;
    return written;
}

// ---------------------------------------------------------------------------
// Frame energies: mean |x| per frame (incl. trailing partial frame)
// ---------------------------------------------------------------------------

// Float32 pairwise |x| summation with NumPy's exact reduction structure
// (numpy pairwise_sum_FLOAT, PW_BLOCKSIZE = 128): bit-identical to
// np.abs(x).sum() / np.abs(x).mean() on float32 input, so the native and
// NumPy-fallback hysteresis machines see the SAME energy at threshold
// boundaries (advisor finding r3: a double-accumulated energy can differ
// by 1 ulp from NumPy's float32 pairwise mean and flip a hysteresis
// decision exactly at a threshold). Parity is pinned by
// tests/test_endpoint_feed.py.
static float pairwise_abs_sum_f32(const float* a, long n) {
    if (n < 8) {
        float res = 0.0f;
        for (long i = 0; i < n; ++i) res += std::fabs(a[i]);
        return res;
    } else if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j) r[j] = std::fabs(a[j]);
        long i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += std::fabs(a[i + j]);
        float res = ((r[0] + r[1]) + (r[2] + r[3])) +
                    ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += std::fabs(a[i]);
        return res;
    }
    long n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_abs_sum_f32(a, n2) + pairwise_abs_sum_f32(a + n2, n - n2);
}

long frame_energies(const float* x, long n, int frame_size, float* out) {
    long n_full = n / frame_size;
    for (long t = 0; t < n_full; ++t)
        out[t] = pairwise_abs_sum_f32(x + t * frame_size, frame_size)
                 / (float)frame_size;
    long rem = n - n_full * frame_size;
    if (rem > 0) {
        out[n_full] = pairwise_abs_sum_f32(x + n_full * frame_size, rem)
                      / (float)rem;
        return n_full + 1;
    }
    return n_full;
}

// ---------------------------------------------------------------------------
// Endpointing automaton (identical semantics to audio/endpointing.py)
// ---------------------------------------------------------------------------
// Per-frame bit flags: bit 0 = frame is part of the speech result,
// bit 1 = frame was collected as noise. (A non-speech frame inside the
// speech region carries both bits, matching the Python machine which appends
// it to `noise` AND `result` — audio/endpointing.py:_segment.)
// Returns the 1-based frame count at which segmentation completed, or 0 if
// it never completed (no trailing silence long enough).

long endpoint_frames(const float* energies, long n_frames, float high,
                     float low, int max_silence, unsigned char* labels) {
    int counter = 0;
    bool between = false, ever_high = false;
    for (long t = 0; t < n_frames; ++t) {
        bool done = false;
        float e = energies[t];
        unsigned char lab = 0;
        if (between) {
            if (e > low) {
                counter = 0;
            } else {
                between = false;
                counter += 1;
                done = counter >= max_silence;
            }
        } else {
            if (e > high) {
                between = true;
                ever_high = true;
                counter = 0;
            } else {
                lab |= 2;  // noise
                if (ever_high) {
                    counter += 1;
                    done = counter >= max_silence;
                }
            }
        }
        if (ever_high) lab |= 1;  // result
        labels[t] = lab;
        if (done) return t + 1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Stateful streaming endpointer (the serving hot path)
// ---------------------------------------------------------------------------
// One call processes a chunk of EXACT full frames for one session: computes
// each frame's mean-|x| energy and advances the same hysteresis machine as
// endpoint_frames, carrying state across calls. `state` is 3 int32s owned by
// the caller: {silence counter, between flag, ever_high flag}. Per-frame
// labels use bit 0 = frame belongs to the speech result (identical to the
// live Segmentation machine in audio/capture.py:126-159, which appends the
// frame to _results whenever ever_high is set). Returns the 1-based frame
// index (within THIS call) at which the take ended, or 0 if it did not end;
// frames past the endpoint are untouched — the caller re-feeds them to a
// fresh state so inter-utterance audio is never lost.

long endpoint_feed(int32_t* state, const float* samples, long n_frames,
                   int frame_size, float high, float low, int max_silence,
                   unsigned char* labels) {
    int counter = state[0];
    bool between = state[1] != 0;
    bool ever_high = state[2] != 0;
    long done = 0;
    for (long t = 0; t < n_frames; ++t) {
        const float* p = samples + t * frame_size;
        float e = pairwise_abs_sum_f32(p, frame_size) / (float)frame_size;
        bool fin = false;
        if (between) {
            if (e > low) {
                counter = 0;
            } else {
                between = false;
                counter += 1;
                fin = counter >= max_silence;
            }
        } else {
            if (e > high) {
                between = true;
                ever_high = true;
                counter = 0;
            } else if (ever_high) {
                counter += 1;
                fin = counter >= max_silence;
            }
        }
        labels[t] = ever_high ? 1 : 0;
        if (fin) { done = t + 1; break; }
    }
    state[0] = counter;
    state[1] = between ? 1 : 0;
    state[2] = ever_high ? 1 : 0;
    return done;
}

}  // extern "C"
