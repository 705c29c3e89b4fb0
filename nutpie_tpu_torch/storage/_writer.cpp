// Native async trace writer: a C++ thread pool that compresses (zlib) and
// writes chunk files without holding the Python GIL.
//
// Analog of the reference's tokio + zarrs writer pool
// (``src/wrapper.rs:1028-1038``): the sampler's host loop hands off chunk
// buffers and immediately returns to driving the device; compression and
// disk IO happen on background threads.
//
// C ABI (consumed via ctypes, see native.py):
//   void*  writer_create(int n_threads);
//   int    writer_submit(void* w, const char* path, const void* data,
//                        long long size, int level);   // copies data
//   void   writer_flush(void* w);      // blocks until queue drained
//   long long writer_errors(void* w);  // count of failed writes
//   void   writer_destroy(void* w);
//
// Build (native.py, into nutpie_tpu_torch/_build/):
//   g++ -O2 -shared -fPIC -std=c++17 -o libwriter-<hash>.so _writer.cpp -lz -lpthread

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

#include <zlib.h>

namespace {

struct Job {
    std::string path;
    std::vector<unsigned char> data;
    int level;
};

class Writer {
  public:
    explicit Writer(int n_threads) : stop_(false), in_flight_(0), errors_(0) {
        if (n_threads < 1) n_threads = 1;
        for (int i = 0; i < n_threads; ++i) {
            threads_.emplace_back([this] { this->worker(); });
        }
    }

    ~Writer() {
        {
            std::unique_lock<std::mutex> lock(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : threads_) t.join();
    }

    int submit(const char* path, const void* data, long long size, int level) {
        Job job;
        job.path = path;
        job.data.assign(static_cast<const unsigned char*>(data),
                        static_cast<const unsigned char*>(data) + size);
        job.level = level;
        {
            std::unique_lock<std::mutex> lock(mu_);
            if (stop_) return -1;
            queue_.push_back(std::move(job));
            ++in_flight_;
        }
        cv_.notify_one();
        return 0;
    }

    void flush() {
        std::unique_lock<std::mutex> lock(mu_);
        done_cv_.wait(lock, [this] { return in_flight_ == 0; });
    }

    long long errors() const { return errors_.load(); }

  private:
    void worker() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lock(mu_);
                cv_.wait(lock, [this] { return stop_ || !queue_.empty(); });
                if (queue_.empty()) {
                    if (stop_) return;
                    continue;
                }
                job = std::move(queue_.front());
                queue_.pop_front();
            }
            if (!write_job(job)) errors_.fetch_add(1);
            {
                std::unique_lock<std::mutex> lock(mu_);
                if (--in_flight_ == 0) done_cv_.notify_all();
            }
        }
    }

    static bool write_job(const Job& job) {
        uLongf bound = compressBound(job.data.size());
        std::vector<unsigned char> out(bound);
        if (compress2(out.data(), &bound, job.data.data(), job.data.size(),
                      job.level) != Z_OK) {
            return false;
        }
        std::string tmp = job.path + ".tmp";
        FILE* f = std::fopen(tmp.c_str(), "wb");
        if (!f) return false;
        bool ok = std::fwrite(out.data(), 1, bound, f) == bound;
        ok = std::fclose(f) == 0 && ok;
        if (ok) ok = std::rename(tmp.c_str(), job.path.c_str()) == 0;
        if (!ok) std::remove(tmp.c_str());
        return ok;
    }

    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    std::deque<Job> queue_;
    std::vector<std::thread> threads_;
    bool stop_;
    long long in_flight_;
    std::atomic<long long> errors_;
};

}  // namespace

extern "C" {

void* writer_create(int n_threads) { return new Writer(n_threads); }

int writer_submit(void* w, const char* path, const void* data, long long size,
                  int level) {
    return static_cast<Writer*>(w)->submit(path, data, size, level);
}

void writer_flush(void* w) { static_cast<Writer*>(w)->flush(); }

long long writer_errors(void* w) { return static_cast<Writer*>(w)->errors(); }

void writer_destroy(void* w) { delete static_cast<Writer*>(w); }

}  // extern "C"
