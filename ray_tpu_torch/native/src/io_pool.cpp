// Native parallel file I/O pool (libtpuio.so).
//
// The reference's data plane does file IO in native code (Arrow C++ readers
// under python/ray/data's datasources). This is the port's
// equivalent: a pthread pool doing pread/pwrite into caller-provided
// buffers. Python calls through ctypes, which drops the GIL for the
// duration, so N files stream concurrently while Python decodes/uses the
// previous batch — the input pipeline's job is to keep the host side of
// the card fed without stealing interpreter time.
//
// C ABI (no C++ types cross the boundary):
//   tio_pool_create(threads)            -> pool*
//   tio_pool_destroy(pool)
//   tio_file_size(path)                 -> int64 size | -errno
//   tio_submit_read(pool, path, off, len, dest)  -> job id
//   tio_submit_write(pool, path, off, len, src, trunc) -> job id
//   tio_wait(pool, id)                  -> int64 bytes | -errno (reaps job)
//
// Every submitted job MUST be waited on: the pool owns no buffers, the
// caller's dest/src must stay alive until tio_wait returns.

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unordered_map>
#include <vector>
#include <unistd.h>

namespace {

struct Job {
  uint64_t id;
  bool is_write;
  bool trunc;
  std::string path;
  uint64_t offset;
  uint64_t length;
  void* buf;
  int64_t result = 0;
  bool done = false;
};

struct Pool {
  std::mutex mu;
  std::condition_variable cv_work;   // workers wait for jobs
  std::condition_variable cv_done;   // waiters wait for completion
  std::deque<Job*> queue;
  std::unordered_map<uint64_t, Job*> jobs;
  std::vector<std::thread> threads;
  uint64_t next_id = 1;
  bool stopping = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; i++) {
      threads.emplace_back([this] { Run(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto& t : threads) t.join();
    for (auto& kv : jobs) delete kv.second;   // unclaimed jobs
    for (auto* j : queue) delete j;
  }

  static int64_t DoRead(Job* j) {
    int fd = open(j->path.c_str(), O_RDONLY);
    if (fd < 0) return -errno;
    size_t total = 0;
    char* dst = static_cast<char*>(j->buf);
    while (total < j->length) {
      ssize_t n = pread(fd, dst + total, j->length - total, j->offset + total);
      if (n < 0) {
        int e = errno;
        if (e == EINTR) continue;
        close(fd);
        return -e;
      }
      if (n == 0) break;  // EOF
      total += n;
    }
    close(fd);
    return static_cast<int64_t>(total);
  }

  static int64_t DoWrite(Job* j) {
    int flags = O_WRONLY | O_CREAT | (j->trunc ? O_TRUNC : 0);
    int fd = open(j->path.c_str(), flags, 0644);
    if (fd < 0) return -errno;
    size_t total = 0;
    const char* src = static_cast<const char*>(j->buf);
    while (total < j->length) {
      ssize_t n = pwrite(fd, src + total, j->length - total, j->offset + total);
      if (n < 0) {
        int e = errno;
        if (e == EINTR) continue;
        close(fd);
        return -e;
      }
      total += n;
    }
    close(fd);
    return static_cast<int64_t>(total);
  }

  void Run() {
    for (;;) {
      Job* j;
      {
        std::unique_lock<std::mutex> g(mu);
        cv_work.wait(g, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        j = queue.front();
        queue.pop_front();
      }
      int64_t r = j->is_write ? DoWrite(j) : DoRead(j);
      {
        std::lock_guard<std::mutex> g(mu);
        j->result = r;
        j->done = true;
      }
      cv_done.notify_all();
    }
  }

  uint64_t Submit(Job* j) {
    std::lock_guard<std::mutex> g(mu);
    j->id = next_id++;
    jobs[j->id] = j;
    queue.push_back(j);
    cv_work.notify_one();
    return j->id;
  }

  int64_t Wait(uint64_t id) {
    std::unique_lock<std::mutex> g(mu);
    auto it = jobs.find(id);
    if (it == jobs.end()) return -EINVAL;
    Job* j = it->second;
    cv_done.wait(g, [j] { return j->done; });
    int64_t r = j->result;
    jobs.erase(it);
    delete j;
    return r;
  }
};

}  // namespace

extern "C" {

void* tio_pool_create(int threads) {
  if (threads < 1) threads = 1;
  return new Pool(threads);
}

void tio_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int64_t tio_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -errno;
  return static_cast<int64_t>(st.st_size);
}

uint64_t tio_submit_read(void* pool, const char* path, uint64_t offset,
                         uint64_t length, void* dest) {
  Job* j = new Job{0, false, false, path, offset, length, dest};
  return static_cast<Pool*>(pool)->Submit(j);
}

uint64_t tio_submit_write(void* pool, const char* path, uint64_t offset,
                          uint64_t length, void* src, int trunc) {
  Job* j = new Job{0, true, trunc != 0, path, offset, length, src};
  return static_cast<Pool*>(pool)->Submit(j);
}

int64_t tio_wait(void* pool, uint64_t id) {
  return static_cast<Pool*>(pool)->Wait(id);
}

}  // extern "C"
