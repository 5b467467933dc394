// Native NIfTI-1 payload reader: gzip inflate + header parse in C++.
//
// The host data loader's read path: it inflates .nii.gz in C (zlib), parses
// the NIfTI-1 header, and fills a caller-provided buffer with the raw voxel
// payload, all without holding the Python GIL (ctypes releases it around
// the call), so loader threads scale past the interpreter lock.
//
// Scope: little-endian NIfTI-1 files (the common case). The numpy codec in
// core/nifti.py reads the files this reader refuses (byte-swapped headers,
// a short payload).
//
// Copied from segmentation_pipeline_tpu/native/nifti_io.cpp. Built at first
// use by segmentation_pipeline_torch/native.py (g++ -O3 -shared -fPIC, linked
// with -lz) into build/torch_kernels/, keyed by a hash of this source and
// its flags.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct Header {
    int32_t sizeof_hdr;
    int16_t dim[8];
    int16_t datatype;
    int16_t bitpix;
    float pixdim[8];
    float vox_offset;
    float scl_slope;
    float scl_inter;
};

bool parse_header(const uint8_t* raw, size_t n, Header* h) {
    if (n < 348) return false;
    std::memcpy(&h->sizeof_hdr, raw + 0, 4);
    if (h->sizeof_hdr != 348) return false;  // big-endian -> python fallback
    std::memcpy(h->dim, raw + 40, 16);
    std::memcpy(&h->datatype, raw + 70, 2);
    std::memcpy(&h->bitpix, raw + 72, 2);
    std::memcpy(h->pixdim, raw + 76, 32);
    std::memcpy(&h->vox_offset, raw + 108, 4);
    std::memcpy(&h->scl_slope, raw + 112, 4);
    std::memcpy(&h->scl_inter, raw + 116, 4);
    const uint8_t* magic = raw + 344;
    if (!((magic[0] == 'n' && (magic[1] == '+' || magic[1] == 'i')))) return false;
    return true;
}

// read just the first max_bytes (cheap header peek: gzread stops early)
bool read_file_prefix(const char* path, std::vector<uint8_t>& out, size_t max_bytes) {
    size_t len = std::strlen(path);
    if (len > 3 && std::strcmp(path + len - 3, ".gz") == 0) {
        gzFile f = gzopen(path, "rb");
        if (!f) return false;
        out.resize(max_bytes);
        int got = gzread(f, out.data(), max_bytes);
        gzclose(f);
        if (got < 0) return false;
        out.resize(static_cast<size_t>(got));
        return true;
    }
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    out.resize(max_bytes);
    size_t got = std::fread(out.data(), 1, max_bytes, f);
    std::fclose(f);
    out.resize(got);
    return true;
}

}  // namespace

extern "C" {

// Pass 1: read header fields. Returns 0 on success, negative on error
// (-1 io, -2 not nifti-1 little-endian). header_out: 16 doubles
// [ndim, dim1..dim7, datatype, bitpix, vox_offset, scl_slope, scl_inter,
//  pixdim1..pixdim3] -- enough for the Python wrapper to allocate.
// Also returns the full header+affine bytes (first 352) in raw348_out.
int nifti_read_header(const char* path, double* header_out, uint8_t* raw352_out) {
    std::vector<uint8_t> buf;
    if (!read_file_prefix(path, buf, 352)) return -1;
    Header h;
    if (!parse_header(buf.data(), buf.size(), &h)) return -2;
    header_out[0] = h.dim[0];
    for (int i = 1; i <= 7; ++i) header_out[i] = h.dim[i];
    header_out[8] = h.datatype;
    header_out[9] = h.bitpix;
    header_out[10] = h.vox_offset;
    header_out[11] = h.scl_slope;
    header_out[12] = h.scl_inter;
    header_out[13] = h.pixdim[1];
    header_out[14] = h.pixdim[2];
    header_out[15] = h.pixdim[3];
    std::memcpy(raw352_out, buf.data(), buf.size() < 352 ? buf.size() : 352);
    return 0;
}

// Pass 2: stream the payload directly into the caller's buffer (no
// intermediate allocation): inflate the header, skip to vox_offset, then
// decompress straight into out. Returns bytes written, or negative on error.
int64_t nifti_read_payload(const char* path, uint8_t* out, int64_t out_bytes) {
    size_t len = std::strlen(path);
    const bool is_gz = len > 3 && std::strcmp(path + len - 3, ".gz") == 0;

    uint8_t head[352];
    size_t offset;
    if (is_gz) {
        gzFile f = gzopen(path, "rb");
        if (!f) return -1;
        gzbuffer(f, 1 << 20);
        int got = gzread(f, head, sizeof(head));
        Header h;
        if (got < 348 || !parse_header(head, static_cast<size_t>(got), &h)) {
            gzclose(f);
            return -2;
        }
        offset = static_cast<size_t>(h.vox_offset >= 348 ? h.vox_offset : 352);
        // skip any remaining pre-payload bytes (extensions)
        if (offset > static_cast<size_t>(got)) {
            if (gzseek(f, static_cast<z_off_t>(offset), SEEK_SET) < 0) {
                gzclose(f);
                return -3;
            }
        } else if (offset < static_cast<size_t>(got)) {
            gzseek(f, static_cast<z_off_t>(offset), SEEK_SET);
        }
        int64_t total = 0;
        while (total < out_bytes) {
            unsigned chunk = static_cast<unsigned>(
                out_bytes - total > (1 << 30) ? (1 << 30) : out_bytes - total);
            int n = gzread(f, out + total, chunk);
            if (n <= 0) break;
            total += n;
        }
        gzclose(f);
        return total;
    }

    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    size_t got = std::fread(head, 1, sizeof(head), f);
    Header h;
    if (got < 348 || !parse_header(head, got, &h)) {
        std::fclose(f);
        return -2;
    }
    offset = static_cast<size_t>(h.vox_offset >= 348 ? h.vox_offset : 352);
    std::fseek(f, static_cast<long>(offset), SEEK_SET);
    size_t n = std::fread(out, 1, static_cast<size_t>(out_bytes), f);
    std::fclose(f);
    return static_cast<int64_t>(n);
}

}  // extern "C"
