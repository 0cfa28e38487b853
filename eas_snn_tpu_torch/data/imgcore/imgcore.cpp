// Host image core of the port: a baseline / extended-sequential /
// progressive Huffman JPEG decoder (one, three or four components) with
// libjpeg-turbo's default decompression arithmetic (the
// islow integer IDCT of jidctint.c, the "fancy" upsamplers of jdsample.c,
// the fixed-point YCbCr->BGR tables of jdcolor.c), and OpenCV's uint8
// INTER_LINEAR resize and warpAffine rules, so that the results equal
// cv2.imread / cv2.resize / cv2.warpAffine bit for bit.
//
// Built by ops/_build.py:host_library with g++ and loaded with ctypes
// (data/image.py). Every function is plain C; errors come back as a
// non-zero code and a message.

#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

// the warp's rounding needs each multiply-add exactly as written (fmaf
// where OpenCV fuses, separate operations where it does not)
#pragma GCC optimize("fp-contract=off")

namespace {

struct Error {
    int code;  // 1 unsupported mode, 2 truncated, 3 corrupt
    std::string msg;
};

const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in the decoder, as jpeg_natural_order's
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
    bool defined = false;
    int maxcode[18];
    int valoff[17];
    uint8_t vals[256];
    // 9-bit lookahead: (length << 8) | symbol, 0 when longer
    uint16_t look[512];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;          // allocated blocks (interleaved layout)
    int dw = 0, dh = 0;          // downsampled width and height
    bool latched = false;
    uint16_t qt[64];             // natural order, latched at first scan
    std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
    int dc_pred = 0;
};

struct Decoder {
    const uint8_t* buf;
    size_t n, pos = 0;
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int restart = 0, orientation = 1;
    bool saw_jfif = false, saw_adobe = false, have_frame = false;
    bool progressive = false;
    int eobrun = 0;  // blocks left in a progressive AC scan's end-of-band run
    int adobe_transform = -1;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    Huff dc[4], ac[4];
    Component comp[4];
    // bit reader
    uint64_t acc = 0;
    int nbits = 0, fake = 0;
    bool hit_eof = false;

    Decoder(const uint8_t* b, size_t len) : buf(b), n(len) {}

    [[noreturn]] void fail(int code, const std::string& m) {
        throw Error{code, m};
    }
    int u8() {
        if (pos >= n) fail(2, "truncated (in a marker segment)");
        return buf[pos++];
    }
    int u16() { int a = u8(); return (a << 8) | u8(); }

    void parse_sof(int marker) {
        static const char* modes[16] = {
            "baseline", "extended sequential", "progressive", "lossless",
            "", "differential sequential (hierarchical)",
            "differential progressive (hierarchical)",
            "differential lossless (hierarchical)", "",
            "arithmetic-coded sequential", "arithmetic-coded progressive",
            "arithmetic-coded lossless", "",
            "arithmetic-coded differential sequential",
            "arithmetic-coded differential progressive",
            "arithmetic-coded differential lossless"};
        int kind = marker - 0xC0;
        if (kind != 0 && kind != 1 && kind != 2)
            fail(1, std::string(modes[kind]) + " JPEG is not supported");
        progressive = kind == 2;
        if (have_frame) fail(3, "corrupt: two frame headers");
        size_t end = pos + u16();
        int precision = u8();
        height = u16();
        width = u16();
        ncomp = u8();
        if (precision != 8)
            fail(1, std::to_string(precision) +
                        "-bit JPEG is not supported (8-bit only)");
        if (ncomp != 1 && ncomp != 3 && ncomp != 4)
            fail(1, std::to_string(ncomp) +
                        "-component JPEG is not supported");
        if (height == 0)
            fail(1, "a JPEG whose height comes in a DNL marker is not "
                    "supported");
        if (width == 0) fail(3, "corrupt: zero width");
        for (int i = 0; i < ncomp; i++) {
            Component& c = comp[i];
            c.id = u8();
            int hv = u8();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = u8();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail(3, "corrupt: bad component sampling or table");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        if (pos != end) fail(3, "corrupt: bad frame header length");
        for (int i = 0; i < ncomp; i++) {
            Component& c = comp[i];
            if (hmax % c.h || vmax % c.v)
                fail(1, "fractional chroma sampling is not supported");
        }
        int mcux = (width + 8 * hmax - 1) / (8 * hmax);
        int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; i++) {
            Component& c = comp[i];
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        }
        have_frame = true;
    }

    void parse_dqt() {
        size_t end = pos + u16();
        while (pos < end) {
            int pq = u8();
            int t = pq & 15, prec = pq >> 4;
            if (t > 3 || prec > 1) fail(3, "corrupt: bad quantization table");
            for (int k = 0; k < 64; k++)
                qt[t][kZigzag[k]] = (uint16_t)(prec ? u16() : u8());
            qt_defined[t] = true;
        }
        if (pos != end) fail(3, "corrupt: bad DQT length");
    }

    void build(Huff& h, const uint8_t* counts, const uint8_t* vals, int nv) {
        std::memcpy(h.vals, vals, nv);
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            h.valoff[l] = k - code;
            k += counts[l - 1];
            code += counts[l - 1];
            if (code > (1 << l)) fail(3, "corrupt: bad Huffman table");
            h.maxcode[l] = counts[l - 1] ? code - 1 : -1;
            code <<= 1;
        }
        h.maxcode[17] = 0x7fffffff;
        std::memset(h.look, 0, sizeof(h.look));
        code = 0;
        k = 0;
        for (int l = 1; l <= 9; l++) {
            for (int i = 0; i < counts[l - 1]; i++, k++, code++) {
                int shift = 9 - l;
                for (int j = 0; j < (1 << shift); j++)
                    h.look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
            }
            code <<= 1;
        }
        h.defined = true;
    }

    void parse_dht() {
        size_t end = pos + u16();
        while (pos < end) {
            int tc = u8();
            int cls = tc >> 4, t = tc & 15;
            if (cls > 1 || t > 3) fail(3, "corrupt: bad Huffman table id");
            uint8_t counts[16], vals[256];
            int nv = 0;
            for (int i = 0; i < 16; i++) nv += counts[i] = (uint8_t)u8();
            if (nv > 256) fail(3, "corrupt: bad Huffman table");
            for (int i = 0; i < nv; i++) vals[i] = (uint8_t)u8();
            build(cls ? ac[t] : dc[t], counts, vals, nv);
        }
        if (pos != end) fail(3, "corrupt: bad DHT length");
    }

    void parse_app1(size_t end) {
        // EXIF orientation (tag 0x0112 of IFD0)
        if (end - pos < 14 || std::memcmp(buf + pos, "Exif\0\0", 6) != 0)
            return;
        const uint8_t* t = buf + pos + 6;
        size_t len = end - pos - 6;
        bool le = t[0] == 'I' && t[1] == 'I';
        if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
        auto r16 = [&](size_t o) -> unsigned {
            return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
        };
        auto r32 = [&](size_t o) -> size_t {
            return le ? (size_t)t[o] | ((size_t)t[o + 1] << 8) |
                            ((size_t)t[o + 2] << 16) | ((size_t)t[o + 3] << 24)
                      : ((size_t)t[o] << 24) | ((size_t)t[o + 1] << 16) |
                            ((size_t)t[o + 2] << 8) | (size_t)t[o + 3];
        };
        if (r16(2) != 42) return;
        size_t ifd = r32(4);
        if (ifd + 2 > len) return;
        unsigned count = r16(ifd);
        for (unsigned i = 0; i < count; i++) {
            size_t e = ifd + 2 + 12 * (size_t)i;
            if (e + 12 > len) return;
            if (r16(e) == 0x0112) {
                unsigned v = r16(e + 8);
                orientation = (v >= 1 && v <= 8) ? (int)v : 1;
                return;
            }
        }
    }

    // ---- entropy-coded data --------------------------------------------
    void reset_bits() { acc = 0; nbits = 0; fake = 0; }

    void fill() {
        while (nbits <= 56) {
            int b = 0;
            if (pos >= n) {
                hit_eof = true;
                fake += 8;
            } else if (buf[pos] == 0xFF) {
                size_t q = pos + 1;
                while (q < n && buf[q] == 0xFF) q++;  // fill bytes
                if (q < n && buf[q] == 0x00) {
                    b = 0xFF;
                    pos = q + 1;
                } else {
                    if (q >= n) hit_eof = true;
                    fake += 8;  // a marker: libjpeg feeds zeros
                }
            } else {
                b = buf[pos++];
            }
            acc |= (uint64_t)b << (56 - nbits);
            nbits += 8;
        }
    }
    inline int bits(int k) {
        if (k == 0) return 0;
        if (nbits < k) fill();
        int v = (int)(acc >> (64 - k));
        acc <<= k;
        nbits -= k;
        return v;
    }
    inline int decode(const Huff& h) {
        if (nbits < 16) fill();
        int e = h.look[acc >> 55];
        if (e) {
            int l = e >> 8;
            acc <<= l;
            nbits -= l;
            return e & 255;
        }
        int l = 10;
        int code = (int)(acc >> (64 - l));
        while (code > h.maxcode[l]) {
            l++;
            if (l > 16) fail(3, "corrupt: bad Huffman code");
            code = (int)(acc >> (64 - l));
        }
        acc <<= l;
        nbits -= l;
        return h.vals[h.valoff[l] + code];
    }
    static inline int extend(int v, int s) {
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }
    void check_overrun() {
        if (nbits < fake)
            fail(hit_eof ? 2 : 3,
                 hit_eof ? "truncated (the image data ends early)"
                         : "corrupt: the image data ends at a marker");
    }

    void decode_block(Component& c, const Huff& dct, const Huff& act,
                      int16_t* blk) {
        int s = decode(dct);
        if (s) {
            if (s > 16) fail(3, "corrupt: bad DC code");
            c.dc_pred += extend(bits(s), s);
        }
        blk[0] = (int16_t)c.dc_pred;
        for (int k = 1; k < 64; k++) {
            int rs = decode(act);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kZigzag[k]] = (int16_t)extend(bits(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    // ---- progressive scans (jdphuff.c): each adds bits to the whole
    // image's coefficients, which the IDCT reads after the last scan
    static inline int16_t shl(int v, int al) {
        return (int16_t)(int)((unsigned)v << al);
    }
    void dc_first(Component& c, const Huff& dct, int16_t* blk, int al) {
        int s = decode(dct);
        if (s) {
            if (s > 16) fail(3, "corrupt: bad DC code");
            c.dc_pred += extend(bits(s), s);
        }
        blk[0] = shl(c.dc_pred, al);
    }
    void dc_refine(int16_t* blk, int al) {
        if (bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
    }
    void ac_first(const Huff& act, int16_t* blk, int ss, int se, int al) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        for (int k = ss; k <= se; k++) {
            int rs = decode(act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[kZigzag[k]] = shl(extend(bits(s), s), al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += bits(r);
                eobrun--;
                break;
            }
        }
    }
    // one refinement bit of every coefficient already non-zero that the
    // scan passes (which does not yet carry bit al)
    inline void refine(int16_t* coef, int p1, int m1) {
        if (bits(1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    }
    void ac_refine(const Huff& act, int16_t* blk, int ss, int se, int al) {
        const int p1 = 1 << al, m1 = -p1;
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; k++) {
                int rs = decode(act);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    // libjpeg warns where s != 1 and reads on
                    s = bits(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += bits(r);
                    break;
                }
                do {
                    int16_t* coef = &blk[kZigzag[k]];
                    if (*coef != 0) {
                        refine(coef, p1, m1);
                    } else if (--r < 0) {
                        break;  // the zero coefficient that takes s
                    }
                    k++;
                } while (k <= se);
                if (s) blk[kZigzag[k]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= se; k++) {
                int16_t* coef = &blk[kZigzag[k]];
                if (*coef != 0) refine(coef, p1, m1);
            }
            eobrun--;
        }
    }

    // one block of the scan (ss, se, ah, al) in component c
    void scan_block(Component& c, int tdc, int tac, int ss, int se, int ah,
                    int al, int16_t* blk) {
        if (!progressive)
            decode_block(c, dc[tdc], ac[tac], blk);
        else if (ss == 0)
            ah ? dc_refine(blk, al) : dc_first(c, dc[tdc], blk, al);
        else
            ah ? ac_refine(ac[tac], blk, ss, se, al)
               : ac_first(ac[tac], blk, ss, se, al);
    }

    void parse_sos() {
        if (!have_frame) fail(3, "corrupt: scan before the frame header");
        size_t end = pos + u16();
        int ns = u8();
        if (ns < 1 || ns > 4) fail(3, "corrupt: bad scan header");
        int idx[4], td[4], ta[4];
        for (int i = 0; i < ns; i++) {
            int cid = u8();
            int t = u8();
            idx[i] = -1;
            for (int j = 0; j < ncomp; j++)
                if (comp[j].id == cid) idx[i] = j;
            if (idx[i] < 0) fail(3, "corrupt: unknown component in a scan");
            td[i] = t >> 4;
            ta[i] = t & 15;
            if (td[i] > 3 || ta[i] > 3)
                fail(3, "corrupt: bad Huffman table id in a scan");
        }
        int ss = u8(), se = u8(), ahal = u8();
        int ah = ahal >> 4, al = ahal & 15;
        if (!progressive && (ss != 0 || se != 63 || ahal != 0))
            fail(3, "corrupt: bad spectral selection for a sequential JPEG");
        if (progressive &&
            ((ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) ||
             al > 13 || (ah != 0 && ah != al + 1)))
            fail(3, "corrupt: bad progressive scan parameters");
        // the tables this scan decodes with: sequential both, a DC first
        // scan DC, a DC refinement none, an AC scan AC
        bool need_dc = !progressive || (ss == 0 && ah == 0);
        bool need_ac = !progressive || ss != 0;
        for (int i = 0; i < ns; i++)
            if ((need_dc && !dc[td[i]].defined) ||
                (need_ac && !ac[ta[i]].defined))
                fail(3, "corrupt: a scan uses an undefined Huffman table");
        if (pos != end) fail(3, "corrupt: bad scan header length");
        for (int i = 0; i < ns; i++) {
            Component& c = comp[idx[i]];
            c.dc_pred = 0;
            if (!c.latched) {
                if (!qt_defined[c.tq])
                    fail(3, "corrupt: undefined quantization table");
                std::memcpy(c.qt, qt[c.tq], sizeof(c.qt));
                c.latched = true;
            }
        }
        reset_bits();
        eobrun = 0;
        int mcux, mcuy;
        if (ns == 1) {
            Component& c = comp[idx[0]];
            mcux = (c.dw + 7) / 8;
            mcuy = (c.dh + 7) / 8;
        } else {
            mcux = (width + 8 * hmax - 1) / (8 * hmax);
            mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        }
        long long done = 0;
        int next_rst = 0;
        for (int my = 0; my < mcuy; my++) {
            for (int mx = 0; mx < mcux; mx++) {
                if (restart && done && done % restart == 0) {
                    // a restart marker: drop the padding bits, expect RSTn
                    check_overrun();
                    reset_bits();
                    if (pos + 1 >= n) fail(2, "truncated (at a restart)");
                    while (pos + 1 < n && buf[pos] == 0xFF &&
                           buf[pos + 1] == 0xFF)
                        pos++;
                    if (buf[pos] != 0xFF || buf[pos + 1] != 0xD0 + next_rst)
                        fail(3, "corrupt: missing restart marker");
                    pos += 2;
                    next_rst = (next_rst + 1) & 7;
                    for (int i = 0; i < ns; i++) comp[idx[i]].dc_pred = 0;
                    eobrun = 0;
                }
                if (ns == 1) {
                    Component& c = comp[idx[0]];
                    int16_t* blk = &c.coef[((size_t)my * c.bw + mx) * 64];
                    scan_block(c, td[0], ta[0], ss, se, ah, al, blk);
                } else {
                    for (int i = 0; i < ns; i++) {
                        Component& c = comp[idx[i]];
                        for (int by = 0; by < c.v; by++)
                            for (int bx = 0; bx < c.h; bx++) {
                                size_t row = (size_t)my * c.v + by;
                                size_t col = (size_t)mx * c.h + bx;
                                scan_block(c, td[i], ta[i], ss, se, ah, al,
                                           &c.coef[(row * c.bw + col) * 64]);
                            }
                    }
                }
                check_overrun();
                done++;
            }
        }
        // skip what is left of the entropy-coded segment up to a marker
        reset_bits();
        while (pos + 1 < n &&
               !(buf[pos] == 0xFF && buf[pos + 1] != 0x00 &&
                 buf[pos + 1] != 0xFF))
            pos++;
    }

    // ---- markers -----------------------------------------------------------
    // Reads the next marker and its segment. Returns false at EOI, and
    // at a scan header without ``scans`` (left unread).
    bool next_marker(bool scans) {
        while (pos < n && buf[pos] != 0xFF) pos++;  // extraneous bytes
        while (pos < n && buf[pos] == 0xFF) pos++;
        if (pos >= n) fail(2, "truncated (no end-of-image marker)");
        int m = buf[pos++];
        if (m == 0xD9) return false;
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
            parse_sof(m);
        } else if (m == 0xC4) {
            parse_dht();
        } else if (m == 0xCC) {
            fail(1, "arithmetic-coded JPEG is not supported");
        } else if (m == 0xDB) {
            parse_dqt();
        } else if (m == 0xDD) {
            size_t end = pos + u16();
            restart = u16();
            pos = end;
        } else if (m == 0xDA) {
            if (!scans) {
                pos -= 2;
                return false;
            }
            parse_sos();
        } else if (m == 0xDC) {
            fail(1, "a JPEG with a DNL marker is not supported");
        } else if (m >= 0xD0 && m <= 0xD7) {
            // stray restart marker: nothing to read
        } else if (m == 0xD8 || m == 0x01) {
            // SOI again or TEM: no segment
        } else {
            size_t len = u16();
            if (len < 2) fail(3, "corrupt: bad marker length");
            size_t end = pos + len - 2;
            if (end > n) fail(2, "truncated (in a marker segment)");
            if (m == 0xE0 && len >= 7 && std::memcmp(buf + pos, "JFIF\0", 5) == 0)
                saw_jfif = true;
            if (m == 0xE1) parse_app1(end);
            if (m == 0xEE && len >= 14 && std::memcmp(buf + pos, "Adobe", 5) == 0) {
                saw_adobe = true;
                adobe_transform = buf[pos + 11];
            }
            pos = end;
        }
        return true;
    }

    void header() {
        if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8)
            fail(3, "not a JPEG file");
        pos = 2;
        // the markers up to the first scan, as cv2 reads them (EXIF too)
        while (next_marker(false)) {
        }
        if (!have_frame) fail(3, "corrupt: no frame header");
    }

    void run() {
        while (next_marker(true)) {
        }
        for (int i = 0; i < ncomp; i++)
            if (!comp[i].latched) fail(3, "corrupt: a component has no scan");
    }
};

// ---- islow IDCT (jidctint.c) ------------------------------------------------
inline int clamp_sample(long long x) {
    // the SIMD IDCT's saturating pack: clamp(x + 128, 0, 255)
    x += 128;
    return x < 0 ? 0 : (x > 255 ? 255 : (int)x);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    const long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                    F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                    F1961 = 16069, F2053 = 16819, F2562 = 20995,
                    F3072 = 25172;
    const int CB = 13, P1 = 2;
    int ws[64];
    for (int c = 0; c < 8; c++) {
        long long z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        auto d = [&](int r) { return (long long)in[r * 8 + c] * q[r * 8 + c]; };
        z2 = d(2);
        z3 = d(6);
        z1 = (z2 + z3) * F0541;
        t2 = z1 + z3 * (-F1847);
        t3 = z1 + z2 * F0765;
        z2 = d(0);
        z3 = d(4);
        t0 = (z2 + z3) * (1LL << CB);
        t1 = (z2 - z3) * (1LL << CB);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = d(7);
        t1 = d(5);
        t2 = d(3);
        t3 = d(1);
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * F1175;
        t0 *= F0298;
        t1 *= F2053;
        t2 *= F3072;
        t3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int s = CB - P1;
        const long long r = 1LL << (s - 1);
        ws[0 * 8 + c] = (int)((t10 + t3 + r) >> s);
        ws[7 * 8 + c] = (int)((t10 - t3 + r) >> s);
        ws[1 * 8 + c] = (int)((t11 + t2 + r) >> s);
        ws[6 * 8 + c] = (int)((t11 - t2 + r) >> s);
        ws[2 * 8 + c] = (int)((t12 + t1 + r) >> s);
        ws[5 * 8 + c] = (int)((t12 - t1 + r) >> s);
        ws[3 * 8 + c] = (int)((t13 + t0 + r) >> s);
        ws[4 * 8 + c] = (int)((t13 - t0 + r) >> s);
    }
    for (int rw = 0; rw < 8; rw++) {
        const int* w = ws + rw * 8;
        long long z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = w[2];
        z3 = w[6];
        z1 = (z2 + z3) * F0541;
        t2 = z1 + z3 * (-F1847);
        t3 = z1 + z2 * F0765;
        t0 = ((long long)w[0] + w[4]) * (1LL << CB);
        t1 = ((long long)w[0] - w[4]) * (1LL << CB);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = w[7];
        t1 = w[5];
        t2 = w[3];
        t3 = w[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * F1175;
        t0 *= F0298;
        t1 *= F2053;
        t2 *= F3072;
        t3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int s = CB + P1 + 3;
        const long long r = 1LL << (s - 1);
        uint8_t* o = out + (size_t)rw * stride;
        o[0] = (uint8_t)clamp_sample((t10 + t3 + r) >> s);
        o[7] = (uint8_t)clamp_sample((t10 - t3 + r) >> s);
        o[1] = (uint8_t)clamp_sample((t11 + t2 + r) >> s);
        o[6] = (uint8_t)clamp_sample((t11 - t2 + r) >> s);
        o[2] = (uint8_t)clamp_sample((t12 + t1 + r) >> s);
        o[5] = (uint8_t)clamp_sample((t12 - t1 + r) >> s);
        o[3] = (uint8_t)clamp_sample((t13 + t0 + r) >> s);
        o[4] = (uint8_t)clamp_sample((t13 - t0 + r) >> s);
    }
}

// ---- upsampling (jdsample.c) to the full W x H plane ------------------------
// plane: the component's IDCT output (stride ps); rows and columns past
// (dw, dh) are never read: edges replicate the last real sample.
void upsample(const uint8_t* p, int ps, int dw, int dh, int rh, int rv,
              int W, int H, uint8_t* out) {
    std::vector<uint8_t> row((size_t)2 * dw + 2);
    std::vector<int> sums((size_t)dw);
    for (int y = 0; y < H; y++) {
        uint8_t* o = out + (size_t)y * W;
        if (rh == 1 && rv == 1) {
            std::memcpy(o, p + (size_t)y * ps, W);
        } else if (rh == 2 && rv == 1) {
            const uint8_t* in = p + (size_t)y * ps;
            uint8_t* r = row.data();
            if (dw > 2) {  // h2v1_fancy_upsample
                r[0] = in[0];
                r[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
                for (int i = 1; i < dw - 1; i++) {
                    int v = in[i] * 3;
                    r[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
                    r[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
                }
                r[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
                r[2 * dw - 1] = in[dw - 1];
            } else {
                for (int i = 0; i < dw; i++) r[2 * i] = r[2 * i + 1] = in[i];
            }
            std::memcpy(o, r, W);
        } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
            int inrow = y >> 1, vv = y & 1;
            int other = vv ? std::min(inrow + 1, dh - 1) : std::max(inrow - 1, 0);
            const uint8_t* i0 = p + (size_t)inrow * ps;
            const uint8_t* i1 = p + (size_t)other * ps;
            int bias = vv ? 2 : 1;
            for (int x = 0; x < W; x++)
                o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
        } else if (rh == 2 && rv == 2 && dw > 2) {
            // h2v2_fancy_upsample
            int inrow = y >> 1, vv = y & 1;
            int other = vv ? std::min(inrow + 1, dh - 1) : std::max(inrow - 1, 0);
            const uint8_t* i0 = p + (size_t)inrow * ps;
            const uint8_t* i1 = p + (size_t)other * ps;
            int* s = sums.data();
            for (int i = 0; i < dw; i++) s[i] = i0[i] * 3 + i1[i];
            uint8_t* r = row.data();
            r[0] = (uint8_t)((s[0] * 4 + 8) >> 4);
            r[1] = (uint8_t)((s[0] * 3 + s[1] + 7) >> 4);
            for (int i = 1; i < dw - 1; i++) {
                r[2 * i] = (uint8_t)((s[i] * 3 + s[i - 1] + 8) >> 4);
                r[2 * i + 1] = (uint8_t)((s[i] * 3 + s[i + 1] + 7) >> 4);
            }
            r[2 * dw - 2] = (uint8_t)((s[dw - 1] * 3 + s[dw - 2] + 8) >> 4);
            r[2 * dw - 1] = (uint8_t)((s[dw - 1] * 4 + 7) >> 4);
            std::memcpy(o, r, W);
        } else {  // int_upsample / h2v2_upsample / h2v1_upsample: boxes
            const uint8_t* in = p + (size_t)(y / rv) * ps;
            for (int x = 0; x < W; x++) o[x] = in[x / rh];
        }
    }
}

// ---- colour conversion (jdcolor.c) -------------------------------------------
inline uint8_t lim(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// build_ycc_rgb_table: the fixed-point YCbCr -> RGB terms
struct YCC {
    static const int SB = 16;
    int cr_r[256], cb_b[256];
    long long cr_g[256], cb_g[256];
    YCC() {
        const long long HALF = 1LL << (SB - 1);
        auto FIX = [](double x) { return (long long)(x * (1L << 16) + 0.5); };
        for (int i = 0; i < 256; i++) {
            long long x = i - 128;
            cr_r[i] = (int)((FIX(1.40200) * x + HALF) >> SB);
            cb_b[i] = (int)((FIX(1.77200) * x + HALF) >> SB);
            cr_g[i] = -FIX(0.71414) * x;
            cb_g[i] = -FIX(0.34414) * x + HALF;
        }
    }
    int g(int cb, int cr) const { return (int)((cb_g[cb] + cr_g[cr]) >> SB); }
};

const YCC& ycc_tables() {
    static const YCC t;
    return t;
}

// A 4-component JPEG as cv2.imread gives it: libjpeg decodes CMYK as
// stored (Adobe transform 0, or no Adobe marker) or converts YCCK
// (transform 2; any other is taken for YCCK, as libjpeg does) to CMYK
// (ycck_cmyk_convert), and OpenCV turns the inverted (Adobe) CMYK into
// BGR with channel = k - ((255 - c) * k >> 8).
void cmyk_to_bgr(const std::vector<uint8_t>* planes, bool ycck, size_t n,
                 uint8_t* out) {
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(),
                  *p2 = planes[2].data(), *p3 = planes[3].data();
    const YCC& t = ycc_tables();
    for (size_t i = 0; i < n; i++) {
        int c = p0[i], m = p1[i], y = p2[i], k = p3[i];
        if (ycck) {
            int yy = c, cb = m, cr = y;
            c = lim(255 - (yy + t.cr_r[cr]));
            m = lim(255 - (yy + t.g(cb, cr)));
            y = lim(255 - (yy + t.cb_b[cb]));
        }
        out[3 * i + 2] = (uint8_t)(k - ((255 - c) * k >> 8));
        out[3 * i + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
        out[3 * i] = (uint8_t)(k - ((255 - y) * k >> 8));
    }
}

int decode_impl(const uint8_t* data, size_t n, uint8_t* out, int* info,
                char* err, int errlen, bool pixels) {
    try {
        Decoder d(data, n);
        d.header();
        info[0] = d.height;
        info[1] = d.width;
        info[2] = d.ncomp;
        info[3] = d.orientation;
        if (!pixels) return 0;
        d.run();
        const int W = d.width, H = d.height;
        std::vector<uint8_t> planes[4];
        for (int ci = 0; ci < d.ncomp; ci++) {
            Component& c = d.comp[ci];
            int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
            int ps = c.bw * 8;
            std::vector<uint8_t> plane((size_t)ps * c.bh * 8);
            for (int by = 0; by < nby; by++)
                for (int bx = 0; bx < nbx; bx++)
                    idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.qt,
                               &plane[(size_t)by * 8 * ps + bx * 8], ps);
            planes[ci].resize((size_t)W * H);
            upsample(plane.data(), ps, c.dw, c.dh, d.hmax / c.h, d.vmax / c.v,
                     W, H, planes[ci].data());
        }
        if (d.ncomp == 1) {
            const uint8_t* g = planes[0].data();
            for (size_t i = 0; i < (size_t)W * H; i++)
                out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
            return 0;
        }
        if (d.ncomp == 4) {
            cmyk_to_bgr(planes, d.saw_adobe && d.adobe_transform != 0,
                        (size_t)W * H, out);
            return 0;
        }
        bool rgb;
        if (d.saw_jfif) rgb = false;
        else if (d.saw_adobe) rgb = d.adobe_transform == 0;
        else rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
        const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(),
                      *p2 = planes[2].data();
        if (rgb) {
            for (size_t i = 0; i < (size_t)W * H; i++) {
                out[3 * i] = p2[i];
                out[3 * i + 1] = p1[i];
                out[3 * i + 2] = p0[i];
            }
            return 0;
        }
        const YCC& t = ycc_tables();
        for (size_t i = 0; i < (size_t)W * H; i++) {
            int y = p0[i], cb = p1[i], cr = p2[i];
            out[3 * i + 2] = lim(y + t.cr_r[cr]);
            out[3 * i + 1] = lim(y + t.g(cb, cr));
            out[3 * i] = lim(y + t.cb_b[cb]);
        }
        return 0;
    } catch (const Error& e) {
        std::snprintf(err, errlen, "%s", e.msg.c_str());
        return e.code;
    } catch (const std::bad_alloc&) {
        std::snprintf(err, errlen, "out of memory");
        return 3;
    }
}

}  // namespace

extern "C" {

// (height, width, components, EXIF orientation) of a JPEG: 0 on success,
// 1 an unsupported mode, 2 truncated, 3 corrupt (with a message in err).
int jpeg_header(const uint8_t* data, long long n, int* info, char* err,
                int errlen) {
    return decode_impl(data, (size_t)n, nullptr, info, err, errlen, false);
}

// Decode into out, (height, width, 3) BGR as stored (before the EXIF
// orientation); the same codes as jpeg_header.
int jpeg_decode(const uint8_t* data, long long n, uint8_t* out, int* info,
                char* err, int errlen) {
    return decode_impl(data, (size_t)n, out, info, err, errlen, true);
}

// cv2.resize(src, (ow, oh), interpolation=INTER_LINEAR) on uint8 with cn
// channels: OpenCV's 11-bit fixed-point coefficients, its vector vertical
// pass ((S >> 4) * beta >> 16, summed, (+2) >> 2), and its 2x2 box
// average where the scale is exactly 2 on both axes.
void resize_linear_u8(const uint8_t* src, int ih, int iw, int cn,
                      uint8_t* dst, int oh, int ow) {
    double inv_x = (double)ow / iw, inv_y = (double)oh / ih;
    double sx = 1.0 / inv_x, sy = 1.0 / inv_y;
    int isx = (int)std::lrint(sx), isy = (int)std::lrint(sy);
    const double eps = 2.220446049250313e-16;
    if (std::fabs(sx - isx) < eps && std::fabs(sy - isy) < eps && isx == 2 &&
        isy == 2) {
        for (int y = 0; y < oh; y++) {
            const uint8_t* r0 = src + (size_t)(2 * y) * iw * cn;
            const uint8_t* r1 = r0 + (size_t)iw * cn;
            uint8_t* o = dst + (size_t)y * ow * cn;
            for (int x = 0; x < ow; x++)
                for (int c = 0; c < cn; c++) {
                    int a = 2 * x * cn + c;
                    o[x * cn + c] = (uint8_t)((r0[a] + r0[a + cn] + r1[a] +
                                               r1[a + cn] + 2) >> 2);
                }
        }
        return;
    }
    std::vector<int> xofs(ow), a0(ow), a1(ow);
    for (int x = 0; x < ow; x++) {
        float f = (float)((x + 0.5) * sx - 0.5);
        int s = (int)std::floor(f);
        f -= (float)s;
        if (s < 0) { f = 0.f; s = 0; }
        if (s >= iw - 1) { f = 0.f; s = iw - 1; }
        xofs[x] = s;
        a0[x] = (int)std::lrintf((1.f - f) * 2048.f);
        a1[x] = (int)std::lrintf(f * 2048.f);
    }
    const int rw = ow * cn;
    auto hrow = [&](int r, int* outp) {
        const uint8_t* s = src + (size_t)r * iw * cn;
        for (int x = 0; x < ow; x++) {
            int x0 = xofs[x] * cn, x1 = std::min(xofs[x] + 1, iw - 1) * cn;
            for (int c = 0; c < cn; c++)
                outp[x * cn + c] = s[x0 + c] * a0[x] + s[x1 + c] * a1[x];
        }
    };
    std::vector<int> h0(rw), h1(rw);
    int c0 = -1, c1 = -1;
    for (int y = 0; y < oh; y++) {
        float f = (float)((y + 0.5) * sy - 0.5);
        int s = (int)std::floor(f);
        f -= (float)s;
        int b0 = (int)std::lrintf((1.f - f) * 2048.f);
        int b1 = (int)std::lrintf(f * 2048.f);
        int r0 = std::min(std::max(s, 0), ih - 1);
        int r1 = std::min(std::max(s + 1, 0), ih - 1);
        if (r0 != c0) {
            if (r0 == c1) { std::swap(h0, h1); std::swap(c0, c1); }
            else { hrow(r0, h0.data()); c0 = r0; }
        }
        if (r1 != c1) {
            if (r1 == c0) { h1 = h0; c1 = c0; }
            else { hrow(r1, h1.data()); c1 = r1; }
        }
        uint8_t* o = dst + (size_t)y * rw;
        for (int i = 0; i < rw; i++) {
            int v0 = std::min(std::max(h0[i] >> 4, -32768), 32767);
            int v1 = std::min(std::max(h1[i] >> 4, -32768), 32767);
            int t = (int16_t)(((v0 * b0) >> 16) + ((v1 * b1) >> 16));
            int v = (t + 2) >> 2;
            o[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

// cv2.warpAffine(src, M, (ow, oh), INTER_LINEAR, BORDER_CONSTANT,
// (border,) * cn) on uint8, as OpenCV 5 computes it on an AVX2 host: M
// (2x3, forward, float64) is inverted in float64, then rounded to float32;
// the source coordinates of the columns its vector loop covers (groups of
// 16) are fma(M0, x, y * M1 + M2) in float32, those of its scalar tail
// fma(x, M0, y * M1) + M2; the taps outside the image take the border
// value, and the bilinear blend is three float32 fmas (along x, then y),
// rounded half to even.
void warp_affine_u8(const uint8_t* src, int ih, int iw, int cn,
                    uint8_t* dst, int oh, int ow, const double* Min,
                    int border) {
    double M[6];
    for (int i = 0; i < 6; i++) M[i] = Min[i];
    double D = M[0] * M[4] - M[1] * M[3];
    D = D != 0 ? 1. / D : 0;
    double A11 = M[4] * D, A22 = M[0] * D;
    M[0] = A11;
    M[1] *= -D;
    M[3] *= -D;
    M[4] = A22;
    double b1 = -M[0] * M[2] - M[1] * M[5];
    double b2 = -M[3] * M[2] - M[4] * M[5];
    M[2] = b1;
    M[5] = b2;
    float F[6];
    for (int i = 0; i < 6; i++) F[i] = (float)M[i];
    const float bv = (float)border;
    const int vec_end = ow / 16 * 16;
    for (int y = 0; y < oh; y++) {
        float fy = (float)y;
        float yx = fy * F[1], yy = fy * F[4];
        float mx = yx + F[2];
        float my = yy + F[5];
        uint8_t* o = dst + (size_t)y * ow * cn;
        for (int x = 0; x < ow; x++) {
            float fx = (float)x, sx, sy;
            if (x < vec_end) {
                sx = std::fmaf(F[0], fx, mx);
                sy = std::fmaf(F[3], fx, my);
            } else {
                sx = std::fmaf(fx, F[0], yx) + F[2];
                sy = std::fmaf(fx, F[3], yy) + F[5];
            }
            float flx = std::floor(sx), fly = std::floor(sy);
            // far outside (or not finite): every tap is the border
            if (!(flx > -2.f && flx < (float)iw + 1.f && fly > -2.f &&
                  fly < (float)ih + 1.f)) {
                for (int c = 0; c < cn; c++) o[x * cn + c] = (uint8_t)border;
                continue;
            }
            int ix = (int)flx, iy = (int)fly;
            float ax = sx - flx, ay = sy - fly;
            bool in00 = ix >= 0 && ix < iw && iy >= 0 && iy < ih;
            bool in01 = ix + 1 >= 0 && ix + 1 < iw && iy >= 0 && iy < ih;
            bool in10 = ix >= 0 && ix < iw && iy + 1 >= 0 && iy + 1 < ih;
            bool in11 = ix + 1 >= 0 && ix + 1 < iw && iy + 1 >= 0 && iy + 1 < ih;
            const uint8_t* s0 = src + ((size_t)iy * iw + ix) * cn;
            const uint8_t* s1 = s0 + (size_t)iw * cn;
            for (int c = 0; c < cn; c++) {
                float p00 = in00 ? s0[c] : bv;
                float p01 = in01 ? s0[cn + c] : bv;
                float p10 = in10 ? s1[c] : bv;
                float p11 = in11 ? s1[cn + c] : bv;
                float v0 = std::fmaf(ax, p01 - p00, p00);
                float v1 = std::fmaf(ax, p11 - p10, p10);
                float v = std::fmaf(ay, v1 - v0, v0);
                long r = std::lrintf(v);
                o[x * cn + c] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
            }
        }
    }
}

// PNG's row filters undone: raw holds h rows of a filter-type byte and
// stride bytes, bpp bytes a pixel (1 for depths below 8); the rows go to
// out (h x stride). Returns 0, or the first filter type past 4 (nothing
// read from that row on).
int png_unfilter(const uint8_t* raw, int h, long long stride, int bpp,
                 uint8_t* out) {
    for (int y = 0; y < h; y++) {
        const uint8_t* in = raw + (size_t)y * (stride + 1);
        int type = in[0];
        in++;
        uint8_t* o = out + (size_t)y * stride;
        const uint8_t* up = y ? o - stride : nullptr;
        switch (type) {
            case 0:
                std::memcpy(o, in, stride);
                break;
            case 1:  // Sub
                for (long long i = 0; i < stride; i++)
                    o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
                break;
            case 2:  // Up
                for (long long i = 0; i < stride; i++)
                    o[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
                break;
            case 3:  // Average
                for (long long i = 0; i < stride; i++) {
                    int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
                    o[i] = (uint8_t)(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (long long i = 0; i < stride; i++) {
                    int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
                    int c = (i >= bpp && up) ? up[i - bpp] : 0;
                    int p = a + b - c;
                    int pa = std::abs(p - a), pb = std::abs(p - b),
                        pc = std::abs(p - c);
                    int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    o[i] = (uint8_t)(in[i] + pred);
                }
                break;
            default:
                return type;
        }
    }
    return 0;
}

}  // extern "C"
