// Asynchronous raster-output runtime: a C++ worker pool that drains a
// queue of (path, header, float32 grid) jobs so hourly output writing
// overlaps the accelerator compute instead of stalling the model loop.
//
// The reference writes its hourly output maps synchronously from the C++
// app loop (Crit3DProject::saveHourlyMeteoOutput / gis::writeEsriGrid,
// bin/CRITERIA3D/criteria3DProject.cpp:1274-1283, agrolib/gis/gisIO.cpp);
// here the same .flt/.hdr ESRI binary-grid format is produced by detached
// writer threads behind a C ABI consumed via ctypes
// (criteria3d_tpu_torch/native.py).
//
// Build (criteria3d_tpu_torch/native.py, at first use, into build/):
//   g++ -O2 -shared -fPIC -std=c++17 -pthread output_writer.cpp -o <lib>.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::string path;     // base path without extension
    std::string header;   // full .hdr text
    std::vector<float> data;
};

struct Writer {
    std::vector<std::thread> workers;
    std::deque<Job> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable cv_done;
    std::atomic<int> in_flight{0};
    std::atomic<long> written{0};
    std::atomic<long> errors{0};
    bool stopping = false;

    explicit Writer(int n_threads) {
        for (int i = 0; i < n_threads; ++i)
            workers.emplace_back([this] { run(); });
    }

    ~Writer() {
        {
            std::unique_lock<std::mutex> lk(mu);
            stopping = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
    }

    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return stopping || !queue.empty(); });
                if (queue.empty()) {
                    if (stopping) return;
                    continue;
                }
                job = std::move(queue.front());
                queue.pop_front();
            }
            write(job);
            // Decrement under the mutex: flush() checks its predicate while
            // holding mu, so notifying without the lock could slip between
            // the check and the sleep and the wakeup would be lost (flush /
            // destroy hanging at end of run).
            int remaining;
            {
                std::lock_guard<std::mutex> lk(mu);
                remaining = --in_flight;
            }
            if (remaining == 0) cv_done.notify_all();
        }
    }

    void write(const Job& job) {
        bool ok = true;
        {
            std::string hdr_path = job.path + ".hdr";
            FILE* f = std::fopen(hdr_path.c_str(), "w");
            if (f) {
                std::fwrite(job.header.data(), 1, job.header.size(), f);
                std::fclose(f);
            } else {
                ok = false;
            }
        }
        {
            std::string flt_path = job.path + ".flt";
            FILE* f = std::fopen(flt_path.c_str(), "wb");
            if (f) {
                size_t n = std::fwrite(job.data.data(), sizeof(float),
                                       job.data.size(), f);
                ok = ok && n == job.data.size();
                std::fclose(f);
            } else {
                ok = false;
            }
        }
        if (ok)
            ++written;
        else
            ++errors;
    }

    void submit(const char* path, const char* header, const float* data,
                int64_t n) {
        Job job;
        job.path = path;
        job.header = header;
        job.data.assign(data, data + n);   // copy: caller buffer not retained
        ++in_flight;
        {
            std::unique_lock<std::mutex> lk(mu);
            queue.push_back(std::move(job));
        }
        cv.notify_one();
    }

    void flush() {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [this] { return in_flight.load() == 0; });
    }
};

}  // namespace

extern "C" {

void* c3d_writer_create(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    return new Writer(n_threads);
}

void c3d_writer_submit(void* handle, const char* path, const char* header,
                       const float* data, int64_t n) {
    static_cast<Writer*>(handle)->submit(path, header, data, n);
}

// Block until every queued job has been written.
void c3d_writer_flush(void* handle) {
    static_cast<Writer*>(handle)->flush();
}

long c3d_writer_written(void* handle) {
    return static_cast<Writer*>(handle)->written.load();
}

long c3d_writer_errors(void* handle) {
    return static_cast<Writer*>(handle)->errors.load();
}

void c3d_writer_destroy(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    w->flush();
    delete w;
}

}  // extern "C"
