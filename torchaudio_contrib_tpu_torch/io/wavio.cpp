// wavio — minimal, dependency-free RIFF/WAVE codec for the corpus
// preprocessing path (torchaudio_contrib_tpu.parallel.corpus).
//
// The reference library has no IO of its own (users bring librosa /
// torchaudio loaders — neither exists in this environment); corpus-scale
// preprocessing (BASELINE config 5) needs a fast native decoder so the
// host-side loader keeps up with the TPU.  Supports PCM 16/24/32-bit and
// IEEE float32, mono or interleaved multichannel, read and write.
// Exposed via a C ABI consumed through ctypes (no pybind11 in the image).
//
// Build: see Makefile in this directory (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

namespace {

struct Reader {
    const uint8_t* p;
    size_t n;
    size_t off = 0;

    bool read(void* dst, size_t k) {
        if (off + k > n) return false;
        std::memcpy(dst, p + off, k);
        off += k;
        return true;
    }
    bool skip(size_t k) {
        if (off + k > n) return false;
        off += k;
        return true;
    }
};

uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
         | ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

}  // namespace

extern "C" {

// Parse header: returns 0 on success and fills metadata.
// format_tag: 1 = PCM, 3 = IEEE float.
int wav_info(const uint8_t* buf, size_t len, uint32_t* sample_rate,
             uint16_t* channels, uint16_t* bits, uint64_t* num_frames,
             uint64_t* data_off, uint16_t* format_tag) {
    if (len < 12 || std::memcmp(buf, "RIFF", 4) != 0
        || std::memcmp(buf + 8, "WAVE", 4) != 0)
        return -1;
    size_t off = 12;
    bool have_fmt = false;
    uint16_t fmt = 0, ch = 0, bps = 0;
    uint32_t sr = 0;
    while (off + 8 <= len) {
        const uint8_t* hdr = buf + off;
        uint32_t sz = rd_u32(hdr + 4);
        const uint8_t* body = hdr + 8;
        if (off + 8 + sz > len) return -2;  // truncated chunk
        if (std::memcmp(hdr, "fmt ", 4) == 0) {
            if (sz < 16) return -3;
            fmt = rd_u16(body);
            if (fmt == 0xFFFE && sz >= 40)  // WAVE_FORMAT_EXTENSIBLE
                fmt = rd_u16(body + 24);
            ch = rd_u16(body + 2);
            sr = rd_u32(body + 4);
            bps = rd_u16(body + 14);
            have_fmt = true;
        } else if (std::memcmp(hdr, "data", 4) == 0) {
            if (!have_fmt || ch == 0 || bps == 0) return -4;
            if (fmt != 1 && fmt != 3) return -5;       // PCM / float only
            if (bps != 16 && bps != 24 && bps != 32) return -6;
            if (fmt == 3 && bps != 32) return -6;
            uint32_t frame_bytes = (uint32_t)ch * (bps / 8);
            *sample_rate = sr;
            *channels = ch;
            *bits = bps;
            *num_frames = sz / frame_bytes;
            *data_off = (uint64_t)(body - buf);
            *format_tag = fmt;
            return 0;
        }
        off += 8 + sz + (sz & 1);  // chunks are word-aligned
    }
    return -7;  // no data chunk
}

// Decode interleaved samples to float32 planar (channels, frames),
// normalized to [-1, 1) for integer formats.  out must hold
// channels*num_frames floats.  Returns 0 on success.
int wav_decode(const uint8_t* buf, size_t len, float* out) {
    uint32_t sr;
    uint16_t ch, bits, fmt;
    uint64_t frames, off;
    int rc = wav_info(buf, len, &sr, &ch, &bits, &frames, &off, &fmt);
    if (rc != 0) return rc;
    const uint8_t* d = buf + off;
    const size_t C = ch, F = frames;

    if (fmt == 3) {  // float32
        for (size_t i = 0; i < F; ++i)
            for (size_t c = 0; c < C; ++c) {
                float v;
                std::memcpy(&v, d + (i * C + c) * 4, 4);
                out[c * F + i] = v;
            }
    } else if (bits == 16) {
        const float s = 1.0f / 32768.0f;
        for (size_t i = 0; i < F; ++i)
            for (size_t c = 0; c < C; ++c) {
                int16_t v;
                std::memcpy(&v, d + (i * C + c) * 2, 2);
                out[c * F + i] = (float)v * s;
            }
    } else if (bits == 24) {
        const float s = 1.0f / 8388608.0f;
        for (size_t i = 0; i < F; ++i)
            for (size_t c = 0; c < C; ++c) {
                const uint8_t* q = d + (i * C + c) * 3;
                int32_t v = (int32_t)((uint32_t)q[0] | ((uint32_t)q[1] << 8)
                                      | ((uint32_t)q[2] << 16));
                if (v & 0x800000) v |= ~0xFFFFFF;  // sign-extend
                out[c * F + i] = (float)v * s;
            }
    } else {  // 32-bit PCM
        const float s = 1.0f / 2147483648.0f;
        for (size_t i = 0; i < F; ++i)
            for (size_t c = 0; c < C; ++c) {
                int32_t v;
                std::memcpy(&v, d + (i * C + c) * 4, 4);
                out[c * F + i] = (float)v * s;
            }
    }
    return 0;
}

// Required buffer size (bytes) for encoding; header is 44 bytes.
uint64_t wav_encoded_size(uint64_t num_frames, uint16_t channels,
                          uint16_t bits) {
    return 44u + num_frames * channels * (bits / 8);
}

// Encode float32 planar (channels, frames) to 16-bit PCM or float32 WAV.
// bits must be 16 (PCM) or 32 (IEEE float).  Returns bytes written, or
// negative on error.
int64_t wav_encode(const float* data, uint64_t num_frames,
                   uint16_t channels, uint32_t sample_rate, uint16_t bits,
                   uint8_t* out, uint64_t out_len) {
    if (bits != 16 && bits != 32) return -1;
    const uint16_t fmt = (bits == 32) ? 3 : 1;
    const uint64_t bytes = num_frames * channels * (bits / 8);
    const uint64_t total = 44 + bytes;
    if (out_len < total || total > 0xFFFFFFFFu) return -2;

    auto w_u32 = [&](size_t o, uint32_t v) {
        out[o] = v & 0xFF; out[o + 1] = (v >> 8) & 0xFF;
        out[o + 2] = (v >> 16) & 0xFF; out[o + 3] = (v >> 24) & 0xFF;
    };
    auto w_u16 = [&](size_t o, uint16_t v) {
        out[o] = v & 0xFF; out[o + 1] = (v >> 8) & 0xFF;
    };
    std::memcpy(out, "RIFF", 4);
    w_u32(4, (uint32_t)(total - 8));
    std::memcpy(out + 8, "WAVEfmt ", 8);
    w_u32(16, 16);
    w_u16(20, fmt);
    w_u16(22, channels);
    w_u32(24, sample_rate);
    w_u32(28, sample_rate * channels * (bits / 8));
    w_u16(32, (uint16_t)(channels * (bits / 8)));
    w_u16(34, bits);
    std::memcpy(out + 36, "data", 4);
    w_u32(40, (uint32_t)bytes);

    uint8_t* d = out + 44;
    const size_t C = channels, F = num_frames;
    if (bits == 32) {
        for (size_t i = 0; i < F; ++i)
            for (size_t c = 0; c < C; ++c)
                std::memcpy(d + (i * C + c) * 4, &data[c * F + i], 4);
    } else {
        for (size_t i = 0; i < F; ++i)
            for (size_t c = 0; c < C; ++c) {
                float v = data[c * F + i];
                if (v > 1.0f) v = 1.0f;
                if (v < -1.0f) v = -1.0f;
                int32_t q = (int32_t)(v * 32767.0f);
                int16_t s = (int16_t)q;
                std::memcpy(d + (i * C + c) * 2, &s, 2);
            }
    }
    return (int64_t)total;
}

}  // extern "C"
