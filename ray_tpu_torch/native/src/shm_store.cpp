// Native shared-memory object store: the host-RAM tier of the object store.
//
// Parity with the reference's plasma store (Ray's
// src/ray/object_manager/plasma/store.h, malloc.h, eviction_policy.h):
// an mmap'd arena shared between the host runtime and CPU worker processes,
// holding immutable sealed objects addressed by 20-byte ObjectIDs, with
// zero-copy reads (workers map the same segment and read at an offset).
//
// Deltas: this tier sits BELOW the device object table — hot tensors
// stay on the card; this arena only holds spilled/host-bound objects
// and cross-process payloads, so the allocator favors large blocks over
// plasma's dlmalloc generality.  Layout is process-shared: a header + fixed
// open-addressing index + boundary-tagged block arena, guarded by one robust
// process-shared pthread mutex (plasma instead serializes via a unix-socket
// server thread; a shared-memory mutex removes that round trip).
//
// Object lifecycle (plasma object_lifecycle_manager.h parity):
//   CREATED (writer filling) -> SEALED (immutable, readable) -> deleted when
//   refcount hits zero and delete requested; LRU eviction over sealed,
//   unreferenced objects when an allocation doesn't fit.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7270755354524530ULL;  // "rpuSTRE0"
constexpr uint32_t kIdSize = 20;
constexpr uint32_t kNumSlots = 1 << 16;  // open-addressing index slots
constexpr uint64_t kAlign = 64;

enum SlotState : uint32_t {
  SLOT_EMPTY = 0,
  SLOT_CREATED = 1,
  SLOT_SEALED = 2,
  SLOT_TOMBSTONE = 3,
};

struct Slot {
  uint8_t id[kIdSize];
  uint32_t state;
  uint32_t refcount;
  uint64_t offset;   // offset of payload within the segment
  uint64_t size;     // payload size
  uint64_t lru_tick; // for eviction ordering
  uint64_t meta_size; // leading metadata bytes within payload (serialization envelope)
};

struct BlockHeader {
  uint64_t size;  // payload capacity of this block (excluding header)
  uint32_t free;
  uint32_t _pad;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;      // total segment size
  uint64_t arena_offset;  // where the block arena starts
  uint64_t arena_size;
  uint64_t used_bytes;    // payload bytes in live (created|sealed) objects
  uint64_t lru_clock;
  uint64_t num_objects;
  pthread_mutex_t mutex;
  Slot slots[kNumSlots];
  // block arena follows
};

struct Store {
  Header* hdr;
  uint8_t* base;
  uint64_t map_size;
  char name[256];
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline BlockHeader* block_at(Store* s, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(s->base + off);
}

uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) { h ^= id[i]; h *= 1099511628211ULL; }
  return h;
}

Slot* find_slot(Store* s, const uint8_t* id, bool for_insert) {
  uint64_t h = hash_id(id);
  Slot* first_tombstone = nullptr;
  for (uint32_t probe = 0; probe < kNumSlots; probe++) {
    Slot* slot = &s->hdr->slots[(h + probe) & (kNumSlots - 1)];
    if (slot->state == SLOT_EMPTY) {
      if (for_insert) return first_tombstone ? first_tombstone : slot;
      return nullptr;
    }
    if (slot->state == SLOT_TOMBSTONE) {
      if (for_insert && !first_tombstone) first_tombstone = slot;
      continue;
    }
    if (memcmp(slot->id, id, kIdSize) == 0) return slot;
  }
  return for_insert ? first_tombstone : nullptr;
}

// First-fit scan over the block chain; splits oversized blocks.
int64_t arena_alloc(Store* s, uint64_t want) {
  want = align_up(want, kAlign);
  uint64_t off = s->hdr->arena_offset;
  uint64_t end = s->hdr->arena_offset + s->hdr->arena_size;
  while (off < end) {
    BlockHeader* b = block_at(s, off);
    if (b->free) {
      // coalesce forward while free
      uint64_t next = off + sizeof(BlockHeader) + b->size;
      while (next < end) {
        BlockHeader* nb = block_at(s, next);
        if (!nb->free) break;
        b->size += sizeof(BlockHeader) + nb->size;
        next = off + sizeof(BlockHeader) + b->size;
      }
      if (b->size >= want) {
        uint64_t remainder = b->size - want;
        if (remainder > sizeof(BlockHeader) + kAlign) {
          b->size = want;
          BlockHeader* split = block_at(s, off + sizeof(BlockHeader) + want);
          split->size = remainder - sizeof(BlockHeader);
          split->free = 1;
        }
        b->free = 0;
        return static_cast<int64_t>(off + sizeof(BlockHeader));
      }
    }
    off += sizeof(BlockHeader) + b->size;
  }
  return -1;
}

void arena_free(Store* s, uint64_t payload_off) {
  BlockHeader* b = block_at(s, payload_off - sizeof(BlockHeader));
  b->free = 1;
}

void delete_slot(Store* s, Slot* slot) {
  arena_free(s, slot->offset);
  s->hdr->used_bytes -= slot->size;
  s->hdr->num_objects -= 1;
  slot->state = SLOT_TOMBSTONE;
}

// Evict least-recently-used sealed, unreferenced objects until `need` bytes
// could plausibly be allocated.  Returns bytes freed.
uint64_t evict_lru(Store* s, uint64_t need) {
  uint64_t freed = 0;
  while (freed < need) {
    Slot* victim = nullptr;
    for (uint32_t i = 0; i < kNumSlots; i++) {
      Slot* slot = &s->hdr->slots[i];
      if (slot->state == SLOT_SEALED && slot->refcount == 0) {
        if (!victim || slot->lru_tick < victim->lru_tick) victim = slot;
      }
    }
    if (!victim) break;
    freed += victim->size;
    delete_slot(s, victim);
  }
  return freed;
}

class Guard {
 public:
  explicit Guard(Store* s) : s_(s) {
    int rc = pthread_mutex_lock(&s_->hdr->mutex);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&s_->hdr->mutex);
  }
  ~Guard() { pthread_mutex_unlock(&s_->hdr->mutex); }
 private:
  Store* s_;
};

}  // namespace

extern "C" {

// Open (or create) the named segment.  Returns opaque handle or null.
//
// Exactly ONE process ever initializes a segment: creation races through
// O_EXCL, and every other opener (a losing creator, or a worker mapping the
// creator's arena) WAITS for the initializer's magic instead of checking it.
// The old "init if magic missing" fallback was a real corruption: a worker
// opening in the window between the creator's ftruncate and its magic store
// would memset the header — including the process-shared mutex the creator
// might already hold — and glibc later aborts on the trampled robust mutex
// (observed as pthread_mutex_lock assertion failures under load, where the
// creator can sit descheduled in that window for hundreds of ms).
// Unlink `name` only if it still refers to the same inode we timed out on.
// Two creators timing out on one carcass would otherwise double-unlink: the
// first retries and builds a healthy segment under the name, and the second's
// bare shm_unlink(name) would then remove the HEALTHY one, splitting the
// cluster into disjoint stores.  (A window between our fstat and the unlink
// remains — POSIX has no funlinkat for shm — but it is microseconds against
// the 5-second staleness bar that gates entry to this path.)
static void unlink_if_same_inode(const char* name, dev_t dev, ino_t ino) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return;  // already gone
  struct stat st;
  if (fstat(fd, &st) == 0 && st.st_dev == dev && st.st_ino == ino) {
    shm_unlink(name);
  }
  close(fd);
}

void* tstore_open(const char* name, uint64_t capacity, int create) {
  // The segment must hold the header (index) plus a useful arena.
  const uint64_t min_capacity = align_up(sizeof(Header), kAlign) + (1ULL << 20);
  const uint64_t want_capacity = capacity;

  // attempt 0: normal open.  attempt 1 (create=1 only): the segment existed
  // but its initializer died between shm_open and storing magic/ftruncate,
  // leaving it permanently half-built — unlink the carcass and take over as
  // the O_EXCL winner ourselves.  One retry only: a second timeout means a
  // live-but-wedged initializer, which we must not yank out from under.
  for (int attempt = 0; attempt < 2; attempt++) {
    capacity = create && want_capacity < min_capacity ? min_capacity : want_capacity;
    bool initializer = false;
    int fd = -1;
    if (create) {
      fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
      if (fd >= 0) {
        initializer = true;
      } else if (errno != EEXIST) {
        return nullptr;
      }
    }
    if (fd < 0) {
      fd = shm_open(name, O_RDWR, 0600);
      if (fd < 0) {
        if (create && errno == ENOENT) continue;  // unlinked under us — recreate
        return nullptr;
      }
    }

    // Identity of the segment we actually opened — needed for a safe
    // stale-carcass unlink later (by then the name may point elsewhere).
    struct stat self_st;
    if (fstat(fd, &self_st) != 0) { close(fd); return nullptr; }

    if (initializer) {
      if (ftruncate(fd, capacity) != 0) { close(fd); shm_unlink(name); return nullptr; }
    } else {
      // wait (bounded) for the initializer to size the segment
      struct stat st;
      bool stale = false;
      for (int spin = 0; ; spin++) {
        if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
        if (st.st_size > 0) break;
        if (spin > 5000) { stale = true; break; }  // ~5s
        usleep(1000);
      }
      if (stale) {
        close(fd);
        if (create && attempt == 0) {
          unlink_if_same_inode(name, self_st.st_dev, self_st.st_ino);
          continue;
        }
        return nullptr;
      }
      capacity = st.st_size;
    }

    void* mem = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return nullptr;

    Store* s = new Store();
    s->hdr = reinterpret_cast<Header*>(mem);
    s->base = reinterpret_cast<uint8_t*>(mem);
    s->map_size = capacity;
    snprintf(s->name, sizeof(s->name), "%s", name);

    if (initializer) {
      memset(s->hdr, 0, sizeof(Header));
      s->hdr->capacity = capacity;
      s->hdr->arena_offset = align_up(sizeof(Header), kAlign);
      s->hdr->arena_size = capacity - s->hdr->arena_offset;
      pthread_mutexattr_t attr;
      pthread_mutexattr_init(&attr);
      pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
      pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
      pthread_mutex_init(&s->hdr->mutex, &attr);
      BlockHeader* first = block_at(s, s->hdr->arena_offset);
      first->size = s->hdr->arena_size - sizeof(BlockHeader);
      first->free = 1;
      __sync_synchronize();
      s->hdr->magic = kMagic;
    } else {
      // never initialize a segment someone else created: wait for its magic
      bool stale = false;
      for (int spin = 0; s->hdr->magic != kMagic; spin++) {
        if (spin > 5000) { stale = true; break; }
        usleep(1000);
        __sync_synchronize();
      }
      if (stale) {
        munmap(mem, capacity);
        delete s;
        if (create && attempt == 0) {
          unlink_if_same_inode(name, self_st.st_dev, self_st.st_ino);
          continue;
        }
        return nullptr;
      }
    }
    return s;
  }
  return nullptr;
}

void tstore_close(void* h) {
  Store* s = static_cast<Store*>(h);
  munmap(s->base, s->map_size);
  delete s;
}

void tstore_unlink(const char* name) { shm_unlink(name); }

// Allocate an object; returns payload offset within the segment, or:
//  -1 out of memory (even after eviction), -2 already exists.
int64_t tstore_create(void* h, const uint8_t* id, uint64_t size, uint64_t meta_size) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  Slot* existing = find_slot(s, id, false);
  if (existing) return -2;
  int64_t off = arena_alloc(s, size ? size : 1);
  if (off < 0) {
    evict_lru(s, size);
    off = arena_alloc(s, size ? size : 1);
    if (off < 0) return -1;
  }
  Slot* slot = find_slot(s, id, true);
  if (!slot) { arena_free(s, off); return -1; }
  memcpy(slot->id, id, kIdSize);
  slot->state = SLOT_CREATED;
  slot->refcount = 1;  // creator holds a ref until seal+release
  slot->offset = off;
  slot->size = size;
  slot->meta_size = meta_size;
  slot->lru_tick = ++s->hdr->lru_clock;
  s->hdr->used_bytes += size;
  s->hdr->num_objects += 1;
  return off;
}

int tstore_seal(void* h, const uint8_t* id) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->state != SLOT_CREATED) return -1;
  slot->state = SLOT_SEALED;
  slot->refcount -= 1;
  return 0;
}

// Get a sealed object: returns payload offset or -1; fills size/meta_size.
// Increments refcount (pins against eviction) — pair with tstore_release.
int64_t tstore_get(void* h, const uint8_t* id, uint64_t* size_out, uint64_t* meta_size_out) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->state != SLOT_SEALED) return -1;
  slot->refcount += 1;
  slot->lru_tick = ++s->hdr->lru_clock;
  if (size_out) *size_out = slot->size;
  if (meta_size_out) *meta_size_out = slot->meta_size;
  return static_cast<int64_t>(slot->offset);
}

int tstore_release(void* h, const uint8_t* id) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->refcount == 0) return -1;
  slot->refcount -= 1;
  return 0;
}

int tstore_delete(void* h, const uint8_t* id) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot) return -1;
  if (slot->refcount > 0) return -2;  // pinned
  delete_slot(s, slot);
  return 0;
}

// Resolve an arbitrary segment offset to the SEALED entry whose payload
// contains it (zero-copy passthrough: a serialized buffer that already
// lives in the arena is served by referencing its entry, no staging copy).
// Fills id_out (kIdSize bytes) + payload offset/size; pins the entry
// (refcount++, pair with tstore_release) so the caller can safely offer it.
// Returns 0, or -1 when no sealed entry covers the offset.
int tstore_pin_range(void* h, uint64_t seg_off, uint8_t* id_out,
                     uint64_t* payload_off_out, uint64_t* size_out) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  for (uint32_t i = 0; i < kNumSlots; i++) {
    Slot* slot = &s->hdr->slots[i];
    if (slot->state != SLOT_SEALED) continue;
    if (seg_off >= slot->offset && seg_off < slot->offset + slot->size) {
      slot->refcount += 1;
      slot->lru_tick = ++s->hdr->lru_clock;
      memcpy(id_out, slot->id, kIdSize);
      if (payload_off_out) *payload_off_out = slot->offset;
      if (size_out) *size_out = slot->size;
      return 0;
    }
  }
  return -1;
}

// Pre-fault THIS mapping's pages so a first bulk memcpy runs at reused-page
// rates (~8 vs ~1.6 GB/s measured).  Page-table population is per-VMA:
// every process (and every separate mapping of the segment, e.g. the
// Python-side mmap) must populate its own — callers with their own mapping
// should madvise it directly rather than rely on this one.
int tstore_prefault(void* h) {
#ifdef MADV_POPULATE_WRITE
  Store* s = static_cast<Store*>(h);
  return madvise(s->base, s->map_size, MADV_POPULATE_WRITE);
#else
  (void)h;
  return -1;
#endif
}

int tstore_contains(void* h, const uint8_t* id) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  Slot* slot = find_slot(s, id, false);
  return (slot && slot->state == SLOT_SEALED) ? 1 : 0;
}

uint64_t tstore_used(void* h) { return static_cast<Store*>(h)->hdr->used_bytes; }
uint64_t tstore_capacity(void* h) { return static_cast<Store*>(h)->hdr->arena_size; }
uint64_t tstore_num_objects(void* h) { return static_cast<Store*>(h)->hdr->num_objects; }
uint64_t tstore_evict(void* h, uint64_t need) {
  Store* s = static_cast<Store*>(h);
  Guard g(s);
  return evict_lru(s, need);
}

}  // extern "C"
