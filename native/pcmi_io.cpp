// pcmi_io — native raster I/O runtime for pcmi_tpu.
//
// The reference outsources all raster I/O to GDAL (C++); this library is the
// framework's own native data path: an mmap'd baseline-TIFF decoder (strip or
// tile layout, 8/16/32-bit unsigned + float32/64, little or big endian) and a
// multi-threaded windowed reader with an LRU strip cache, so host-side tile
// feeding never becomes the bottleneck ahead of the device ingest. Exposed as a
// plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread pcmi_io.cpp -o libpcmi_io.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <atomic>
#include <list>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct TiffInfo {
    uint32_t width = 0, height = 0, channels = 1, bits = 8;
    uint32_t sample_format = 1;       // 1=uint, 2=int, 3=float
    uint32_t rows_per_strip = 0;      // strip layout
    uint32_t tile_w = 0, tile_h = 0;  // tile layout (0 = strips)
    std::vector<uint64_t> offsets;    // strip or tile offsets
    bool big_endian = false;
    bool ok = false;
    std::string error;
};

struct Mapped {
    const uint8_t* data = nullptr;
    size_t size = 0;
    int fd = -1;
    ~Mapped() {
        if (data) munmap(const_cast<uint8_t*>(data), size);
        if (fd >= 0) close(fd);
    }
};

bool map_file(const char* path, Mapped& m, std::string& err) {
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) { err = "open failed"; return false; }
    struct stat st;
    if (fstat(m.fd, &st) != 0) { err = "stat failed"; return false; }
    m.size = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) { m.data = nullptr; err = "mmap failed"; return false; }
    m.data = static_cast<const uint8_t*>(p);
    return true;
}

uint64_t rd(const uint8_t* p, int n, bool be) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i)
        v |= static_cast<uint64_t>(p[be ? n - 1 - i : i]) << (8 * i);
    return v;
}

int type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;
        case 3: case 8: return 2;
        case 4: case 9: case 11: return 4;
        case 5: case 10: case 12: case 16: case 17: return 8;
        default: return 1;
    }
}

void parse_tiff(const Mapped& m, TiffInfo& info) {
    if (m.size < 8) { info.error = "too small"; return; }
    const uint8_t* d = m.data;
    bool be;
    if (d[0] == 'I' && d[1] == 'I') be = false;
    else if (d[0] == 'M' && d[1] == 'M') be = true;
    else { info.error = "not a TIFF"; return; }
    info.big_endian = be;
    if (rd(d + 2, 2, be) != 42) { info.error = "bad magic (BigTIFF unsupported)"; return; }
    uint64_t ifd = rd(d + 4, 4, be);
    if (ifd + 2 > m.size) { info.error = "bad IFD offset"; return; }
    uint64_t n = rd(d + ifd, 2, be);
    std::vector<uint64_t> strip_off, tile_off;
    uint32_t compression = 1;
    for (uint64_t i = 0; i < n; ++i) {
        const uint8_t* e = d + ifd + 2 + i * 12;
        if (e + 12 > d + m.size) break;
        uint16_t tag = static_cast<uint16_t>(rd(e, 2, be));
        uint16_t typ = static_cast<uint16_t>(rd(e + 2, 2, be));
        uint32_t cnt = static_cast<uint32_t>(rd(e + 4, 4, be));
        int ts = type_size(typ);
        uint64_t size = static_cast<uint64_t>(ts) * cnt;
        const uint8_t* val = (size <= 4) ? e + 8 : d + rd(e + 8, 4, be);
        if (val + size > d + m.size) continue;
        auto geti = [&](uint32_t k) { return rd(val + k * ts, ts, be); };
        switch (tag) {
            case 256: info.width = static_cast<uint32_t>(geti(0)); break;
            case 257: info.height = static_cast<uint32_t>(geti(0)); break;
            case 258: info.bits = static_cast<uint32_t>(geti(0)); break;
            case 259: compression = static_cast<uint32_t>(geti(0)); break;
            case 273:
                strip_off.resize(cnt);
                for (uint32_t k = 0; k < cnt; ++k) strip_off[k] = geti(k);
                break;
            case 277: info.channels = static_cast<uint32_t>(geti(0)); break;
            case 278: info.rows_per_strip = static_cast<uint32_t>(geti(0)); break;
            case 322: info.tile_w = static_cast<uint32_t>(geti(0)); break;
            case 323: info.tile_h = static_cast<uint32_t>(geti(0)); break;
            case 324:
                tile_off.resize(cnt);
                for (uint32_t k = 0; k < cnt; ++k) tile_off[k] = geti(k);
                break;
            case 339: info.sample_format = static_cast<uint32_t>(geti(0)); break;
            default: break;
        }
    }
    if (compression != 1) { info.error = "compressed TIFF unsupported"; return; }
    if (!info.width || !info.height) { info.error = "missing dims"; return; }
    if (!tile_off.empty()) {
        if (!info.tile_w || !info.tile_h) {
            info.error = "tiled layout without TileWidth/TileLength";
            return;
        }
        info.offsets = std::move(tile_off);
    } else {
        info.tile_w = info.tile_h = 0;  // strips even if tag 322/323 present
        info.offsets = std::move(strip_off);
        if (!info.rows_per_strip) info.rows_per_strip = info.height;
    }
    if (info.offsets.empty()) { info.error = "no data offsets"; return; }
    info.ok = true;
}

void byteswap(uint8_t* p, size_t count, int esize) {
    for (size_t i = 0; i < count; ++i) {
        uint8_t* q = p + i * esize;
        for (int a = 0, b = esize - 1; a < b; ++a, --b) std::swap(q[a], q[b]);
    }
}

struct Reader {
    Mapped map;
    TiffInfo info;
    size_t pixel_bytes() const { return (info.bits / 8) * info.channels; }

    // copy a window [y0, y0+h) x [x0, x0+w) into out (row-major, native endian)
    bool read_window(uint32_t y0, uint32_t x0, uint32_t h, uint32_t w,
                     uint8_t* out) const {
        const size_t pb = pixel_bytes();
        const int esize = info.bits / 8;
        const bool swap = info.big_endian;
        if (y0 + h > info.height || x0 + w > info.width) return false;
        if (info.tile_w) {
            const uint32_t tw = info.tile_w, th = info.tile_h;
            const uint32_t across = (info.width + tw - 1) / tw;
            for (uint32_t ty = y0 / th; ty <= (y0 + h - 1) / th; ++ty) {
                for (uint32_t tx = x0 / tw; tx <= (x0 + w - 1) / tw; ++tx) {
                    const uint64_t idx = static_cast<uint64_t>(ty) * across + tx;
                    if (idx >= info.offsets.size()) return false;
                    // offsets from untrusted files: payload must fit the map
                    if (info.offsets[idx] +
                        static_cast<uint64_t>(tw) * th * pb > map.size)
                        return false;
                    const uint8_t* tile = map.data + info.offsets[idx];
                    const uint32_t ys = std::max(y0, ty * th);
                    const uint32_t ye = std::min(y0 + h, (ty + 1) * th);
                    const uint32_t xs = std::max(x0, tx * tw);
                    const uint32_t xe = std::min(x0 + w, (tx + 1) * tw);
                    for (uint32_t y = ys; y < ye; ++y) {
                        const uint8_t* src = tile +
                            ((y - ty * th) * static_cast<size_t>(tw) + (xs - tx * tw)) * pb;
                        uint8_t* dst = out +
                            ((y - y0) * static_cast<size_t>(w) + (xs - x0)) * pb;
                        std::memcpy(dst, src, static_cast<size_t>(xe - xs) * pb);
                    }
                }
            }
        } else {
            const uint32_t rps = info.rows_per_strip;
            for (uint32_t y = y0; y < y0 + h; ++y) {
                const uint32_t s = y / rps;
                if (s >= info.offsets.size()) return false;
                const uint64_t row_off = info.offsets[s] +
                    ((y - s * rps) * static_cast<uint64_t>(info.width) + x0) * pb;
                // untrusted offsets: the row must fit inside the mapping
                if (row_off + static_cast<uint64_t>(w) * pb > map.size)
                    return false;
                std::memcpy(out + (y - y0) * static_cast<size_t>(w) * pb,
                            map.data + row_off, static_cast<size_t>(w) * pb);
            }
        }
        if (swap && esize > 1)
            byteswap(out, static_cast<size_t>(h) * w * info.channels, esize);
        return true;
    }
};

// ---------------------------------------------------------------------------
// prefetching windowed loader with LRU window cache
// ---------------------------------------------------------------------------

struct CacheEntry {
    std::vector<uint8_t> data;
};

struct Loader {
    std::vector<Reader*> readers;
    uint32_t tile = 1024;
    size_t capacity = 0, used = 0;
    std::unordered_map<std::string, std::list<std::pair<std::string, CacheEntry>>::iterator> index;
    std::list<std::pair<std::string, CacheEntry>> lru;
    std::mutex mu;
    std::vector<std::thread> workers;
    std::list<std::tuple<int, uint32_t, uint32_t>> queue;
    std::mutex qmu;
    std::atomic<bool> stop{false};

    std::string key(int img, uint32_t ty, uint32_t tx) const {
        char buf[64];
        std::snprintf(buf, sizeof buf, "%d:%u:%u", img, ty, tx);
        return buf;
    }

    bool fetch(int img, uint32_t ty, uint32_t tx, CacheEntry& out_entry) {
        Reader* r = readers[img];
        const uint32_t y0 = ty * tile, x0 = tx * tile;
        if (y0 >= r->info.height || x0 >= r->info.width) return false;
        const uint32_t h = std::min(tile, r->info.height - y0);
        const uint32_t w = std::min(tile, r->info.width - x0);
        out_entry.data.resize(static_cast<size_t>(h) * w * r->pixel_bytes());
        return r->read_window(y0, x0, h, w, out_entry.data.data());
    }

    // Copy a cached window into out (inserting on miss). The copy happens
    // UNDER the cache mutex: returning a pointer into the LRU list would
    // race with prefetch-worker evictions (use-after-free). Returns the
    // entry size, -1 on decode error, -2 if out_bytes is too small; pass
    // out == nullptr (prefetch path) to populate the cache without copying.
    long get_into(int img, uint32_t ty, uint32_t tx,
                  uint8_t* out, uint64_t out_bytes) {
        const std::string k = key(img, ty, tx);
        {
            std::lock_guard<std::mutex> lk(mu);
            auto it = index.find(k);
            if (it != index.end()) {
                lru.splice(lru.begin(), lru, it->second);
                const auto& data = it->second->second.data;
                if (!out) return static_cast<long>(data.size());
                if (data.size() > out_bytes) return -2;
                std::memcpy(out, data.data(), data.size());
                return static_cast<long>(data.size());
            }
        }
        CacheEntry e;
        if (!fetch(img, ty, tx, e)) return -1;
        const size_t n = e.data.size();
        if (out) {
            if (n > out_bytes) return -2;
            std::memcpy(out, e.data.data(), n);
        }
        std::lock_guard<std::mutex> lk(mu);
        if (index.find(k) == index.end()) {  // raced insert?
            used += n;
            lru.emplace_front(k, std::move(e));
            index[k] = lru.begin();
            while (used > capacity && lru.size() > 1) {
                auto& back = lru.back();
                used -= back.second.data.size();
                index.erase(back.first);
                lru.pop_back();
            }
        }
        return static_cast<long>(n);
    }

    void worker() {
        while (!stop.load()) {
            std::tuple<int, uint32_t, uint32_t> job;
            {
                std::lock_guard<std::mutex> lk(qmu);
                if (queue.empty()) { }
                else { job = queue.front(); queue.pop_front(); goto have; }
            }
            std::this_thread::sleep_for(std::chrono::milliseconds(1));
            continue;
        have:
            get_into(std::get<0>(job), std::get<1>(job), std::get<2>(job),
                     nullptr, 0);
        }
    }
};

}  // namespace

extern "C" {

// ---- single-shot API -------------------------------------------------------

void* pcmi_open(const char* path) {
    auto* r = new Reader();
    std::string err;
    if (!map_file(path, r->map, err)) { delete r; return nullptr; }
    parse_tiff(r->map, r->info);
    if (!r->info.ok) { delete r; return nullptr; }
    return r;
}

void pcmi_close(void* h) { delete static_cast<Reader*>(h); }

// info: [width, height, channels, bits, sample_format, tiled]
void pcmi_info(void* h, uint32_t* out6) {
    auto* r = static_cast<Reader*>(h);
    out6[0] = r->info.width;
    out6[1] = r->info.height;
    out6[2] = r->info.channels;
    out6[3] = r->info.bits;
    out6[4] = r->info.sample_format;
    out6[5] = r->info.tile_w ? 1u : 0u;
}

int pcmi_read_window(void* h, uint32_t y0, uint32_t x0, uint32_t hh,
                     uint32_t ww, uint8_t* out) {
    return static_cast<Reader*>(h)->read_window(y0, x0, hh, ww, out) ? 0 : -1;
}

// ---- cached, prefetching loader --------------------------------------------

void* pcmi_loader_create(const char** paths, int n, uint32_t tile,
                         uint64_t cache_bytes, int n_threads) {
    auto* L = new Loader();
    L->tile = tile;
    L->capacity = cache_bytes;
    for (int i = 0; i < n; ++i) {
        void* h = pcmi_open(paths[i]);
        if (!h) {
            for (auto* r : L->readers) delete r;
            delete L;
            return nullptr;
        }
        L->readers.push_back(static_cast<Reader*>(h));
    }
    for (int i = 0; i < n_threads; ++i)
        L->workers.emplace_back([L] { L->worker(); });
    return L;
}

void pcmi_loader_destroy(void* h) {
    auto* L = static_cast<Loader*>(h);
    L->stop.store(true);
    for (auto& t : L->workers) t.join();
    for (auto* r : L->readers) delete r;
    delete L;
}

// synchronous cached window read; also enqueues the 4-neighbour prefetch
int pcmi_loader_get(void* h, int img, uint32_t ty, uint32_t tx,
                    uint8_t* out, uint64_t out_bytes) {
    auto* L = static_cast<Loader*>(h);
    long n = L->get_into(img, ty, tx, out, out_bytes);
    if (n < 0) return static_cast<int>(n);
    if (!L->workers.empty()) {  // no workers -> nothing ever drains the queue
        std::lock_guard<std::mutex> lk(L->qmu);
        if (L->queue.size() < 64) {  // bound redundant hot-tile enqueues
            L->queue.push_back({img, ty + 1, tx});
            L->queue.push_back({img, ty, tx + 1});
            if (ty) L->queue.push_back({img, ty - 1, tx});
            if (tx) L->queue.push_back({img, ty, tx - 1});
        }
    }
    return static_cast<int>(n);
}

}  // extern "C"
