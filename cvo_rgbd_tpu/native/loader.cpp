// Threaded prefetching RGB-D frame loader.
//
// Native-runtime replacement of the reference's synchronous per-frame
// `load_img` (cvo_main.cpp:36-52): worker threads read and decode
// upcoming (rgb, depth) PNG pairs into a bounded ring while the device
// registers the current pair, so host IO never blocks device compute.
//
// C API (ctypes-friendly):
//   loader_create(paths, n, w, h, workers, depth_w, depth_h) -> handle
//   loader_next(handle, rgb_out[h*w*3] u8, depth_out[dh*dw] u16) -> idx or <0
//   loader_destroy(handle)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int png_probe(const uint8_t*, size_t, int*, int*, int*, int*);
extern "C" int png_decode(const uint8_t*, size_t, void*);

namespace {

struct Frame {
    int index = -1;
    int status = 0;  // 0 ok, nonzero error
    std::vector<uint8_t> rgb;
    std::vector<uint16_t> depth;
};

struct Loader {
    std::vector<std::string> rgb_paths;
    std::vector<std::string> dep_paths;
    int w = 0, h = 0, dw = 0, dh = 0;
    size_t ahead = 8;

    std::mutex mu;
    std::condition_variable cv_done;
    std::condition_variable cv_space;
    std::map<int, Frame> ready;
    int next_to_fetch = 0;    // guarded by mu
    int next_to_serve = 0;
    bool stop = false;
    std::vector<std::thread> workers;

    ~Loader() { shutdown(); }

    void shutdown() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv_space.notify_all();
        cv_done.notify_all();
        for (auto& t : workers) {
            if (t.joinable()) t.join();
        }
        workers.clear();
    }

    static bool slurp(const std::string& path, std::vector<uint8_t>& buf) {
        std::ifstream f(path, std::ios::binary | std::ios::ate);
        if (!f) return false;
        auto sz = f.tellg();
        buf.resize(static_cast<size_t>(sz));
        f.seekg(0);
        f.read(reinterpret_cast<char*>(buf.data()), sz);
        return bool(f);
    }

    int decode_rgb(const std::string& path, std::vector<uint8_t>& out) {
        std::vector<uint8_t> buf;
        if (!slurp(path, buf)) return -20;
        int pw, ph, ch, depth;
        if (png_probe(buf.data(), buf.size(), &pw, &ph, &ch, &depth) != 0)
            return -21;
        if (pw != w || ph != h || depth != 8) return -22;
        std::vector<uint8_t> tmp(static_cast<size_t>(pw) * ph * ch);
        int rc = png_decode(buf.data(), buf.size(), tmp.data());
        if (rc != 0) return rc;
        out.resize(static_cast<size_t>(pw) * ph * 3);
        if (ch == 3) {
            out = std::move(tmp);
        } else if (ch == 4) {  // drop alpha
            for (size_t i = 0; i < static_cast<size_t>(pw) * ph; ++i) {
                out[3 * i] = tmp[4 * i];
                out[3 * i + 1] = tmp[4 * i + 1];
                out[3 * i + 2] = tmp[4 * i + 2];
            }
        } else if (ch == 1) {  // grayscale -> replicate
            for (size_t i = 0; i < static_cast<size_t>(pw) * ph; ++i) {
                out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = tmp[i];
            }
        } else {
            return -23;
        }
        return 0;
    }

    int decode_depth(const std::string& path, std::vector<uint16_t>& out) {
        std::vector<uint8_t> buf;
        if (!slurp(path, buf)) return -30;
        int pw, ph, ch, depth;
        if (png_probe(buf.data(), buf.size(), &pw, &ph, &ch, &depth) != 0)
            return -31;
        if (pw != dw || ph != dh || ch != 1 || depth != 16) return -32;
        out.resize(static_cast<size_t>(pw) * ph);
        return png_decode(buf.data(), buf.size(), out.data());
    }

    void worker() {
        for (;;) {
            int idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] {
                    return stop ||
                           (next_to_fetch < static_cast<int>(rgb_paths.size()) &&
                            next_to_fetch < next_to_serve + static_cast<int>(ahead));
                });
                if (stop) return;
                idx = next_to_fetch++;
            }
            Frame fr;
            fr.index = idx;
            int rc = decode_rgb(rgb_paths[idx], fr.rgb);
            if (rc == 0) rc = decode_depth(dep_paths[idx], fr.depth);
            fr.status = rc;
            {
                std::lock_guard<std::mutex> lk(mu);
                ready.emplace(idx, std::move(fr));
            }
            cv_done.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* loader_create(const char** rgb_paths, const char** dep_paths, int n,
                    int w, int h, int dw, int dh, int workers, int ahead) {
    auto* L = new Loader();
    L->rgb_paths.assign(rgb_paths, rgb_paths + n);
    L->dep_paths.assign(dep_paths, dep_paths + n);
    L->w = w;
    L->h = h;
    L->dw = dw;
    L->dh = dh;
    L->ahead = ahead > 0 ? ahead : 8;
    int nw = workers > 0 ? workers : 2;
    for (int i = 0; i < nw; ++i) {
        L->workers.emplace_back(&Loader::worker, L);
    }
    return L;
}

// Blocks until the next sequential frame is decoded; copies it out.
// Returns the frame index, or negative error (status of the decode).
int loader_next(void* handle, uint8_t* rgb_out, uint16_t* depth_out) {
    auto* L = static_cast<Loader*>(handle);
    int want;
    Frame fr;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        want = L->next_to_serve;
        if (want >= static_cast<int>(L->rgb_paths.size())) return -1;
        L->cv_done.wait(lk, [&] { return L->ready.count(want) || L->stop; });
        if (L->stop && !L->ready.count(want)) return -2;
        fr = std::move(L->ready[want]);
        L->ready.erase(want);
        L->next_to_serve = want + 1;
    }
    L->cv_space.notify_all();
    if (fr.status != 0) return fr.status;
    memcpy(rgb_out, fr.rgb.data(), fr.rgb.size());
    memcpy(depth_out, fr.depth.data(), fr.depth.size() * sizeof(uint16_t));
    return want;
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
