/* Native hot-path tier of ray_tpu_torch (the JAX package keeps its own copy
 * of this file; the type names below are the port's, so a pickled id loads
 * as the port's class): C implementations of the identifier types that sit
 * on every submit/result path (dict keys in the scheduler, refcount, object
 * store and pending-call tables) and of the frame codec the socket loops run.
 *
 * Role parity with the reference's Cython bridge (`python/ray/_raylet.pyx`
 * wrapping `src/ray/common/id.h` BaseID<T> and the task submission hot
 * path): the reference keeps IDs and the submit loop in C++ and lets Python
 * only touch them through Cython; here the runtime is Python-first, so the
 * native tier is inverted — C types that plug into the existing Python
 * runtime.  Semantics mirror ray_tpu_torch/core/ids.py exactly (layouts, nil
 * conventions, counter-minted TaskIDs, put/return index bit).
 *
 * Everything is immutable after construction; the only mutable module state
 * is the two GIL-protected mint counters (task unique, job serial).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/random.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#define JOB_ID_SIZE 4
#define ACTOR_UNIQUE_SIZE 8
#define ACTOR_ID_SIZE 12
#define TASK_UNIQUE_SIZE 8
#define TASK_ID_SIZE 20
#define OBJECT_INDEX_SIZE 4
#define OBJECT_ID_SIZE 24
#define NODE_ID_SIZE 16
#define PG_UNIQUE_SIZE 12
#define PG_ID_SIZE 16
#define WORKER_ID_SIZE 16
#define MAX_ID_SIZE 24

/* ------------------------------------------------------------------ */
/* ID object                                                           */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    Py_hash_t hash;
    PyObject *bytes; /* owned PyBytes of exactly the type's size */
} IDObject;

typedef struct {
    PyTypeObject type;
    int size;          /* <= 0 marks the abstract base (not instantiable) */
    int kind;          /* mixed into the hash so equal bytes of different
                          kinds don't collide in mixed-key dicts */
    IDObject *nil;     /* cached nil instance (all 0xff) */
} IDType;

/* The base is itself an IDType so classmethods inherited onto it (nil,
 * from_random, ...) can safely cast their `cls` — they reject it via the
 * size sentinel instead of reading past a plain PyTypeObject. */
static IDType BaseID_TypeSpec;
#define BaseID_Type (BaseID_TypeSpec.type)

static inline int
id_check(PyObject *o)
{
    return PyType_IsSubtype(Py_TYPE(o), &BaseID_Type);
}

/* Validate a classmethod's cls: must be one of this module's own static
 * types.  A Python heap subclass of the exported BaseID is NOT an IDType —
 * downcasting it would read type fields past PyTypeObject — and the
 * abstract base itself carries a negative size sentinel. */
static IDType *
concrete_id_type(PyObject *cls)
{
    PyTypeObject *tp = (PyTypeObject *)cls;
    if (tp->tp_flags & Py_TPFLAGS_HEAPTYPE) {
        PyErr_Format(PyExc_TypeError,
                     "%s: id classmethods are not inherited by Python subclasses",
                     tp->tp_name);
        return NULL;
    }
    IDType *t = (IDType *)cls;
    if (t->size <= 0) {
        PyErr_Format(PyExc_TypeError, "%s is abstract; use a concrete id type",
                     tp->tp_name);
        return NULL;
    }
    return t;
}

static inline IDType *
id_type(PyObject *o)
{
    return (IDType *)Py_TYPE(o);
}

static Py_hash_t
mix_hash(PyObject *bytes, int kind)
{
    Py_hash_t h = PyObject_Hash(bytes);
    if (h == -1)
        return -1;
    h ^= (Py_hash_t)kind * (Py_hash_t)0x9e3779b97f4a7c15ULL;
    if (h == -1)
        h = -2;
    return h;
}

/* Build an instance of `cls` from a C buffer (no validation). */
static PyObject *
id_from_buf(PyTypeObject *cls, const char *buf, Py_ssize_t len)
{
    PyObject *bytes = PyBytes_FromStringAndSize(buf, len);
    if (bytes == NULL)
        return NULL;
    IDObject *self = (IDObject *)cls->tp_alloc(cls, 0);
    if (self == NULL) {
        Py_DECREF(bytes);
        return NULL;
    }
    self->bytes = bytes;
    self->hash = mix_hash(bytes, ((IDType *)cls)->kind);
    if (self->hash == -1) {
        Py_DECREF(self);
        return NULL;
    }
    return (PyObject *)self;
}

static PyObject *
id_new(PyTypeObject *cls, PyObject *args, PyObject *kwargs)
{
    PyObject *binary;
    static char *kwlist[] = {"binary", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O", kwlist, &binary))
        return NULL;
    IDType *t = (IDType *)cls;
    PyObject *bytes;
    if (PyBytes_CheckExact(binary)) {
        bytes = Py_NewRef(binary);
    }
    else {
        bytes = PyBytes_FromObject(binary); /* bytearray/memoryview input */
        if (bytes == NULL)
            return NULL;
    }
    if (PyBytes_GET_SIZE(bytes) != t->size) {
        PyErr_Format(PyExc_ValueError, "%s requires %d bytes, got %zd",
                     cls->tp_name, t->size, PyBytes_GET_SIZE(bytes));
        Py_DECREF(bytes);
        return NULL;
    }
    IDObject *self = (IDObject *)cls->tp_alloc(cls, 0);
    if (self == NULL) {
        Py_DECREF(bytes);
        return NULL;
    }
    self->bytes = bytes;
    self->hash = mix_hash(bytes, t->kind);
    if (self->hash == -1) {
        Py_DECREF(self);
        return NULL;
    }
    return (PyObject *)self;
}

static void
id_dealloc(IDObject *self)
{
    Py_XDECREF(self->bytes);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static Py_hash_t
id_hash(IDObject *self)
{
    return self->hash;
}

static PyObject *
id_richcompare(PyObject *a, PyObject *b, int op)
{
    if (!id_check(a) || !id_check(b)) {
        if (op == Py_EQ)
            Py_RETURN_FALSE;
        if (op == Py_NE)
            Py_RETURN_TRUE;
        Py_RETURN_NOTIMPLEMENTED;
    }
    IDObject *x = (IDObject *)a, *y = (IDObject *)b;
    if (op == Py_EQ || op == Py_NE) {
        int eq = Py_TYPE(a) == Py_TYPE(b) && x->hash == y->hash &&
                 PyBytes_GET_SIZE(x->bytes) == PyBytes_GET_SIZE(y->bytes) &&
                 memcmp(PyBytes_AS_STRING(x->bytes), PyBytes_AS_STRING(y->bytes),
                        (size_t)PyBytes_GET_SIZE(x->bytes)) == 0;
        if (op == Py_NE)
            eq = !eq;
        return PyBool_FromLong(eq);
    }
    /* ordering compares raw bytes, like the Python classes' __lt__ */
    return PyObject_RichCompare(x->bytes, y->bytes, op);
}

static PyObject *
id_binary(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return Py_NewRef(self->bytes);
}

static PyObject *
id_hex(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return PyObject_CallMethod(self->bytes, "hex", NULL);
}

static PyObject *
id_is_nil(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    const char *p = PyBytes_AS_STRING(self->bytes);
    Py_ssize_t n = PyBytes_GET_SIZE(self->bytes);
    for (Py_ssize_t i = 0; i < n; i++) {
        if ((unsigned char)p[i] != 0xff)
            Py_RETURN_FALSE;
    }
    Py_RETURN_TRUE;
}

static const char *
short_name(PyTypeObject *t)
{
    const char *dot = strrchr(t->tp_name, '.');
    return dot ? dot + 1 : t->tp_name;
}

static PyObject *
id_repr(IDObject *self)
{
    PyObject *hex = id_hex(self, NULL);
    if (hex == NULL)
        return NULL;
    PyObject *out = PyUnicode_FromFormat("%s(%U)", short_name(Py_TYPE(self)), hex);
    Py_DECREF(hex);
    return out;
}

static PyObject *
id_reduce(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return Py_BuildValue("(O(O))", Py_TYPE(self), self->bytes);
}

static PyObject *
id_nil(PyObject *cls, PyObject *Py_UNUSED(ignored))
{
    IDType *t = concrete_id_type(cls);
    if (t == NULL)
        return NULL;
    if (t->nil != NULL)
        return Py_NewRef((PyObject *)t->nil);
    char buf[MAX_ID_SIZE];
    memset(buf, 0xff, (size_t)t->size);
    PyObject *inst = id_from_buf((PyTypeObject *)cls, buf, t->size);
    if (inst == NULL)
        return NULL;
    t->nil = (IDObject *)Py_NewRef(inst); /* cached for the module's life */
    return inst;
}

static PyObject *
id_from_random(PyObject *cls, PyObject *Py_UNUSED(ignored))
{
    IDType *t = concrete_id_type(cls);
    if (t == NULL)
        return NULL;
    char buf[MAX_ID_SIZE];
    if (getentropy(buf, (size_t)t->size) != 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    return id_from_buf((PyTypeObject *)cls, buf, t->size);
}

static PyObject *
id_from_hex(PyObject *cls, PyObject *arg)
{
    if (concrete_id_type(cls) == NULL)
        return NULL;
    PyObject *bytes = PyObject_CallMethod((PyObject *)&PyBytes_Type, "fromhex", "O", arg);
    if (bytes == NULL)
        return NULL;
    PyObject *out = PyObject_CallFunctionObjArgs(cls, bytes, NULL);
    Py_DECREF(bytes);
    return out;
}

static PyMethodDef id_methods[] = {
    {"binary", (PyCFunction)id_binary, METH_NOARGS, "Raw bytes of the id."},
    {"hex", (PyCFunction)id_hex, METH_NOARGS, "Hex string of the id."},
    {"is_nil", (PyCFunction)id_is_nil, METH_NOARGS, "True if all-0xff."},
    {"nil", (PyCFunction)id_nil, METH_NOARGS | METH_CLASS, "All-0xff id."},
    {"from_random", (PyCFunction)id_from_random, METH_NOARGS | METH_CLASS,
     "Cryptographically random id."},
    {"from_hex", (PyCFunction)id_from_hex, METH_O | METH_CLASS, "Parse hex."},
    {"__reduce__", (PyCFunction)id_reduce, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static IDType BaseID_TypeSpec = {
    .type = {PyVarObject_HEAD_INIT(NULL, 0)
                 .tp_name = "ray_tpu_torch.core.ids.BaseID",
             .tp_basicsize = sizeof(IDObject),
             .tp_dealloc = (destructor)id_dealloc,
             .tp_repr = (reprfunc)id_repr,
             .tp_hash = (hashfunc)id_hash,
             .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
             .tp_doc = "Fixed-width binary identifier. Immutable, hashable, ordered.",
             .tp_richcompare = id_richcompare,
             .tp_methods = id_methods},
    /* abstract: size sentinel rejects inherited classmethods; no tp_new —
       concrete subtypes install id_new */
    .size = -1,
    .kind = 0,
    .nil = NULL,
};

/* ---- mint counters (GIL-protected) -------------------------------- */

/* Starts at a RANDOM 62-bit offset (parity: ids.py _task_counter):
 * worker processes mint task ids locally (fire-and-forget nested
 * submission), and two processes counting from a fixed base collide on
 * their early ids.  Seeded in PyInit. */
static uint64_t task_counter = 2;
static uint64_t job_counter = 0;

static inline void
put_le64(char *dst, uint64_t v)
{
    for (int i = 0; i < 8; i++)
        dst[i] = (char)((v >> (8 * i)) & 0xff);
}

static inline void
put_le32(char *dst, uint32_t v)
{
    for (int i = 0; i < 4; i++)
        dst[i] = (char)((v >> (8 * i)) & 0xff);
}

/* Validated fetch of another id argument's raw bytes. */
static const char *
id_arg_bytes(PyObject *arg, int size, const char *what)
{
    if (!id_check(arg) || PyBytes_GET_SIZE(((IDObject *)arg)->bytes) != size) {
        PyErr_Format(PyExc_TypeError, "expected a %d-byte id for %s", size, what);
        return NULL;
    }
    return PyBytes_AS_STRING(((IDObject *)arg)->bytes);
}

/* ---- JobID -------------------------------------------------------- */

static IDType JobID_Type, NodeID_Type, WorkerID_Type, ActorID_Type,
    TaskID_Type, ObjectID_Type, PlacementGroupID_Type;

static PyObject *
job_from_int(PyObject *cls, PyObject *arg)
{
    uint64_t v = PyLong_AsUnsignedLongLong(arg);
    if (v == (uint64_t)-1 && PyErr_Occurred())
        return NULL;
    if (v >> 32) {
        PyErr_SetString(PyExc_OverflowError, "JobID value exceeds 4 bytes");
        return NULL;
    }
    char buf[JOB_ID_SIZE];
    put_le32(buf, (uint32_t)v);
    return id_from_buf((PyTypeObject *)cls, buf, JOB_ID_SIZE);
}

static PyObject *
job_next(PyObject *cls, PyObject *Py_UNUSED(ignored))
{
    job_counter += 1; /* GIL-atomic */
    char buf[JOB_ID_SIZE];
    put_le32(buf, (uint32_t)job_counter);
    return id_from_buf((PyTypeObject *)cls, buf, JOB_ID_SIZE);
}

static PyObject *
job_ensure_above(PyObject *cls, PyObject *arg)
{
    (void)cls;
    uint64_t v = PyLong_AsUnsignedLongLong(arg);
    if (v == (uint64_t)-1 && PyErr_Occurred())
        return NULL;
    if (v > job_counter)
        job_counter = v;
    Py_RETURN_NONE;
}

static PyObject *
job_int_value(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    const unsigned char *p = (const unsigned char *)PyBytes_AS_STRING(self->bytes);
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
                 ((uint32_t)p[3] << 24);
    return PyLong_FromUnsignedLong(v);
}

static PyMethodDef job_methods[] = {
    {"from_int", (PyCFunction)job_from_int, METH_O | METH_CLASS, NULL},
    {"next", (PyCFunction)job_next, METH_NOARGS | METH_CLASS, NULL},
    {"ensure_above", (PyCFunction)job_ensure_above, METH_O | METH_CLASS,
     "Advance the serial counter past ids restored from a previous process."},
    {"int_value", (PyCFunction)job_int_value, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

/* ---- ActorID ------------------------------------------------------ */

static PyObject *
actor_of(PyObject *cls, PyObject *job)
{
    const char *jb = id_arg_bytes(job, JOB_ID_SIZE, "job_id");
    if (jb == NULL)
        return NULL;
    char buf[ACTOR_ID_SIZE];
    if (getentropy(buf, ACTOR_UNIQUE_SIZE) != 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    memcpy(buf + ACTOR_UNIQUE_SIZE, jb, JOB_ID_SIZE);
    return id_from_buf((PyTypeObject *)cls, buf, ACTOR_ID_SIZE);
}

static PyObject *
actor_job_id(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return id_from_buf((PyTypeObject *)&JobID_Type,
                       PyBytes_AS_STRING(self->bytes) + ACTOR_UNIQUE_SIZE, JOB_ID_SIZE);
}

static PyMethodDef actor_methods[] = {
    {"of", (PyCFunction)actor_of, METH_O | METH_CLASS,
     "Random actor id embedding the job id."},
    {"job_id", (PyCFunction)actor_job_id, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

/* ---- TaskID ------------------------------------------------------- */

static PyObject *
task_for_normal_task(PyObject *cls, PyObject *job)
{
    const char *jb = id_arg_bytes(job, JOB_ID_SIZE, "job_id");
    if (jb == NULL)
        return NULL;
    char buf[TASK_ID_SIZE];
    put_le64(buf, task_counter++); /* GIL-atomic mint */
    memset(buf + TASK_UNIQUE_SIZE, 0xff, ACTOR_UNIQUE_SIZE);
    memcpy(buf + TASK_UNIQUE_SIZE + ACTOR_UNIQUE_SIZE, jb, JOB_ID_SIZE);
    return id_from_buf((PyTypeObject *)cls, buf, TASK_ID_SIZE);
}

static PyObject *
task_for_actor_task(PyObject *cls, PyObject *actor)
{
    const char *ab = id_arg_bytes(actor, ACTOR_ID_SIZE, "actor_id");
    if (ab == NULL)
        return NULL;
    char buf[TASK_ID_SIZE];
    put_le64(buf, task_counter++);
    memcpy(buf + TASK_UNIQUE_SIZE, ab, ACTOR_ID_SIZE);
    return id_from_buf((PyTypeObject *)cls, buf, TASK_ID_SIZE);
}

static PyObject *
task_for_actor_creation(PyObject *cls, PyObject *actor)
{
    const char *ab = id_arg_bytes(actor, ACTOR_ID_SIZE, "actor_id");
    if (ab == NULL)
        return NULL;
    char buf[TASK_ID_SIZE];
    memset(buf, 0, TASK_UNIQUE_SIZE); /* zero prefix marks creation */
    memcpy(buf + TASK_UNIQUE_SIZE, ab, ACTOR_ID_SIZE);
    return id_from_buf((PyTypeObject *)cls, buf, TASK_ID_SIZE);
}

static PyObject *
task_for_driver(PyObject *cls, PyObject *job)
{
    const char *jb = id_arg_bytes(job, JOB_ID_SIZE, "job_id");
    if (jb == NULL)
        return NULL;
    char buf[TASK_ID_SIZE];
    memset(buf, 0xfe, TASK_UNIQUE_SIZE);
    memset(buf + TASK_UNIQUE_SIZE, 0xff, ACTOR_UNIQUE_SIZE);
    memcpy(buf + TASK_UNIQUE_SIZE + ACTOR_UNIQUE_SIZE, jb, JOB_ID_SIZE);
    return id_from_buf((PyTypeObject *)cls, buf, TASK_ID_SIZE);
}

static PyObject *
task_actor_id(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    const char *embedded = PyBytes_AS_STRING(self->bytes) + TASK_UNIQUE_SIZE;
    int nil_prefix = 1;
    for (int i = 0; i < ACTOR_UNIQUE_SIZE; i++) {
        if ((unsigned char)embedded[i] != 0xff) {
            nil_prefix = 0;
            break;
        }
    }
    if (nil_prefix)
        return id_nil((PyObject *)&ActorID_Type, NULL);
    return id_from_buf((PyTypeObject *)&ActorID_Type, embedded, ACTOR_ID_SIZE);
}

static PyObject *
task_job_id(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return id_from_buf((PyTypeObject *)&JobID_Type,
                       PyBytes_AS_STRING(self->bytes) + TASK_ID_SIZE - JOB_ID_SIZE,
                       JOB_ID_SIZE);
}

static PyMethodDef task_methods[] = {
    {"for_normal_task", (PyCFunction)task_for_normal_task, METH_O | METH_CLASS, NULL},
    {"for_actor_task", (PyCFunction)task_for_actor_task, METH_O | METH_CLASS, NULL},
    {"for_actor_creation", (PyCFunction)task_for_actor_creation, METH_O | METH_CLASS,
     "Deterministic: zero unique prefix marks the creation task."},
    {"for_driver", (PyCFunction)task_for_driver, METH_O | METH_CLASS, NULL},
    {"actor_id", (PyCFunction)task_actor_id, METH_NOARGS, NULL},
    {"job_id", (PyCFunction)task_job_id, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

/* ---- ObjectID ----------------------------------------------------- */

static PyObject *
object_for_task_return(PyObject *cls, PyObject *args)
{
    PyObject *task;
    unsigned int index;
    if (!PyArg_ParseTuple(args, "OI", &task, &index))
        return NULL;
    const char *tb = id_arg_bytes(task, TASK_ID_SIZE, "task_id");
    if (tb == NULL)
        return NULL;
    char buf[OBJECT_ID_SIZE];
    memcpy(buf, tb, TASK_ID_SIZE);
    put_le32(buf + TASK_ID_SIZE, index);
    return id_from_buf((PyTypeObject *)cls, buf, OBJECT_ID_SIZE);
}

static PyObject *
object_for_put(PyObject *cls, PyObject *args)
{
    PyObject *task;
    unsigned int put_index;
    if (!PyArg_ParseTuple(args, "OI", &task, &put_index))
        return NULL;
    const char *tb = id_arg_bytes(task, TASK_ID_SIZE, "task_id");
    if (tb == NULL)
        return NULL;
    char buf[OBJECT_ID_SIZE];
    memcpy(buf, tb, TASK_ID_SIZE);
    put_le32(buf + TASK_ID_SIZE, put_index | 0x80000000u);
    return id_from_buf((PyTypeObject *)cls, buf, OBJECT_ID_SIZE);
}

static PyObject *
object_task_id(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return id_from_buf((PyTypeObject *)&TaskID_Type, PyBytes_AS_STRING(self->bytes),
                       TASK_ID_SIZE);
}

static PyObject *
object_job_id(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return id_from_buf((PyTypeObject *)&JobID_Type,
                       PyBytes_AS_STRING(self->bytes) + TASK_ID_SIZE - JOB_ID_SIZE,
                       JOB_ID_SIZE);
}

static inline uint32_t
object_index_raw(IDObject *self)
{
    const unsigned char *p =
        (const unsigned char *)PyBytes_AS_STRING(self->bytes) + TASK_ID_SIZE;
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static PyObject *
object_index(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return PyLong_FromUnsignedLong(object_index_raw(self));
}

static PyObject *
object_is_put(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return PyBool_FromLong((object_index_raw(self) & 0x80000000u) != 0);
}

static PyObject *
object_is_return(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return PyBool_FromLong((object_index_raw(self) & 0x80000000u) == 0);
}

static PyMethodDef object_methods[] = {
    {"for_task_return", (PyCFunction)object_for_task_return, METH_VARARGS | METH_CLASS,
     "index 0 is reserved for puts; returns start at 1 (reference convention)."},
    {"for_put", (PyCFunction)object_for_put, METH_VARARGS | METH_CLASS,
     "puts set the high index bit to avoid collision with returns."},
    {"task_id", (PyCFunction)object_task_id, METH_NOARGS, NULL},
    {"job_id", (PyCFunction)object_job_id, METH_NOARGS, NULL},
    {"index", (PyCFunction)object_index, METH_NOARGS, NULL},
    {"is_put", (PyCFunction)object_is_put, METH_NOARGS, NULL},
    {"is_return", (PyCFunction)object_is_return, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

/* ---- PlacementGroupID --------------------------------------------- */

static PyObject *
pg_of(PyObject *cls, PyObject *job)
{
    const char *jb = id_arg_bytes(job, JOB_ID_SIZE, "job_id");
    if (jb == NULL)
        return NULL;
    char buf[PG_ID_SIZE];
    if (getentropy(buf, PG_UNIQUE_SIZE) != 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    memcpy(buf + PG_UNIQUE_SIZE, jb, JOB_ID_SIZE);
    return id_from_buf((PyTypeObject *)cls, buf, PG_ID_SIZE);
}

static PyObject *
pg_job_id(IDObject *self, PyObject *Py_UNUSED(ignored))
{
    return id_from_buf((PyTypeObject *)&JobID_Type,
                       PyBytes_AS_STRING(self->bytes) + PG_UNIQUE_SIZE, JOB_ID_SIZE);
}

static PyMethodDef pg_methods[] = {
    {"of", (PyCFunction)pg_of, METH_O | METH_CLASS, NULL},
    {"job_id", (PyCFunction)pg_job_id, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

/* ---- concrete type table ------------------------------------------ */

#define CONCRETE_ID_TYPE(NAME, SIZE, KIND, METHODS)                           \
    {                                                                          \
        .type = {PyVarObject_HEAD_INIT(NULL, 0)                                \
                     .tp_name = "ray_tpu_torch.core.ids." #NAME,                     \
                 .tp_basicsize = sizeof(IDObject),                             \
                 .tp_flags = Py_TPFLAGS_DEFAULT,                               \
                 .tp_new = id_new,                                             \
                 .tp_methods = METHODS},                                       \
        .size = SIZE, .kind = KIND, .nil = NULL,                               \
    }

static IDType JobID_Type = CONCRETE_ID_TYPE(JobID, JOB_ID_SIZE, 1, job_methods);
static IDType NodeID_Type = CONCRETE_ID_TYPE(NodeID, NODE_ID_SIZE, 2, NULL);
static IDType WorkerID_Type = CONCRETE_ID_TYPE(WorkerID, WORKER_ID_SIZE, 3, NULL);
static IDType ActorID_Type = CONCRETE_ID_TYPE(ActorID, ACTOR_ID_SIZE, 4, actor_methods);
static IDType TaskID_Type = CONCRETE_ID_TYPE(TaskID, TASK_ID_SIZE, 5, task_methods);
static IDType ObjectID_Type = CONCRETE_ID_TYPE(ObjectID, OBJECT_ID_SIZE, 6, object_methods);
static IDType PlacementGroupID_Type =
    CONCRETE_ID_TYPE(PlacementGroupID, PG_ID_SIZE, 7, pg_methods);

/* ------------------------------------------------------------------ */
/* Frame codec                                                         */
/* ------------------------------------------------------------------ */
/* The wire unit shared by the worker-pool pipe and the head<->agent rpc
 * plane (runtime/protocol.py): 4-byte LE length + payload.  The decoder
 * owns a growable receive buffer and reads as many frames per recv()
 * syscall as the kernel has buffered — the Python loops pay two syscalls
 * and a chunk-list join per frame.  The GIL is released around every
 * blocking syscall. */

typedef struct {
    PyObject_HEAD
    char *buf;
    Py_ssize_t cap;
    Py_ssize_t start; /* valid bytes live in [start, end) */
    Py_ssize_t end;
} DecoderObject;

#define DECODER_INITIAL_CAP (256 * 1024)
#define DECODER_SHRINK_CAP (4 * 1024 * 1024)
/* Largest frame we will ever reserve for.  Legit frames are pickled RPC
 * messages (bulk objects ride the shm arena / chunked data plane, not one
 * frame), so 1 GiB is far above real traffic while keeping a corrupted
 * 4-byte length header from demanding a ~4 GiB allocation.  Overridable via
 * RAY_TPU_MAX_FRAME_BYTES (read once at module init; the pure-Python codec
 * in runtime/protocol.py honors the same env so the two tiers interop). */
#define DECODER_MAX_FRAME_DEFAULT ((Py_ssize_t)1 << 30)
static Py_ssize_t g_max_frame = DECODER_MAX_FRAME_DEFAULT;
#define DECODER_MAX_FRAME g_max_frame
#define DECODER_MIN_SPARE (64 * 1024)

static PyObject *
decoder_new(PyTypeObject *cls, PyObject *args, PyObject *kwargs)
{
    if ((args && PyTuple_GET_SIZE(args) != 0) || (kwargs && PyDict_GET_SIZE(kwargs) != 0)) {
        PyErr_SetString(PyExc_TypeError, "FrameDecoder takes no arguments");
        return NULL;
    }
    DecoderObject *self = (DecoderObject *)cls->tp_alloc(cls, 0);
    if (self == NULL)
        return NULL;
    self->buf = PyMem_Malloc(DECODER_INITIAL_CAP);
    if (self->buf == NULL) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    self->cap = DECODER_INITIAL_CAP;
    self->start = self->end = 0;
    return (PyObject *)self;
}

static void
decoder_dealloc(DecoderObject *self)
{
    PyMem_Free(self->buf);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int
decoder_reserve(DecoderObject *self, Py_ssize_t need)
{
    /* ensure `need` contiguous spare bytes after `end` */
    if (self->cap - self->end >= need)
        return 0;
    Py_ssize_t used = self->end - self->start;
    if (self->start > 0) { /* compact first */
        memmove(self->buf, self->buf + self->start, (size_t)used);
        self->start = 0;
        self->end = used;
        if (self->cap - self->end >= need)
            return 0;
    }
    Py_ssize_t newcap = self->cap;
    while (newcap - used < need) {
        if (newcap > PY_SSIZE_T_MAX / 2) {
            PyErr_NoMemory();
            return -1;
        }
        newcap *= 2;
    }
    char *nb = PyMem_Realloc(self->buf, (size_t)newcap);
    if (nb == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    self->buf = nb;
    self->cap = newcap;
    return 0;
}

static inline uint32_t
read_le32(const char *p)
{
    const unsigned char *u = (const unsigned char *)p;
    return (uint32_t)u[0] | ((uint32_t)u[1] << 8) | ((uint32_t)u[2] << 16) |
           ((uint32_t)u[3] << 24);
}

/* Pop one buffered frame as bytes, or NULL without error if incomplete. */
static PyObject *
decoder_pop(DecoderObject *self)
{
    Py_ssize_t have = self->end - self->start;
    if (have < 4)
        return NULL;
    Py_ssize_t len = (Py_ssize_t)read_le32(self->buf + self->start);
    if (have < 4 + len)
        return NULL;
    PyObject *out = PyBytes_FromStringAndSize(self->buf + self->start + 4, len);
    if (out == NULL)
        return NULL;
    self->start += 4 + len;
    if (self->start == self->end) {
        self->start = self->end = 0;
        if (self->cap > DECODER_SHRINK_CAP) {
            /* a giant frame passed through; don't hold its buffer forever */
            char *nb = PyMem_Realloc(self->buf, DECODER_INITIAL_CAP);
            if (nb != NULL) {
                self->buf = nb;
                self->cap = DECODER_INITIAL_CAP;
            }
        }
    }
    return out;
}

static PyObject *
decoder_read_frame(DecoderObject *self, PyObject *arg)
{
    int fd = (int)PyLong_AsLong(arg);
    if (fd == -1 && PyErr_Occurred())
        return NULL;
    for (;;) {
        PyObject *frame = decoder_pop(self);
        if (frame != NULL || PyErr_Occurred())
            return frame;
        /* need more bytes: if the frame length is known, reserve it all so
         * one big payload never loops through doubling reallocs */
        Py_ssize_t have = self->end - self->start;
        Py_ssize_t need = DECODER_MIN_SPARE;
        if (have >= 4) {
            Py_ssize_t len = (Py_ssize_t)read_le32(self->buf + self->start);
            /* sanity-cap BEFORE reserving: a corrupted length header must
             * not demand a multi-GiB allocation */
            if (len > DECODER_MAX_FRAME) {
                PyErr_Format(PyExc_ValueError,
                             "frame length %zd exceeds max %zd (corrupt header?)",
                             len, (Py_ssize_t)DECODER_MAX_FRAME);
                return NULL;
            }
            need = 4 + len - have;
        }
        if (decoder_reserve(self, need < DECODER_MIN_SPARE ? DECODER_MIN_SPARE : need) < 0)
            return NULL;
        Py_ssize_t n;
        Py_BEGIN_ALLOW_THREADS
        n = recv(fd, self->buf + self->end, (size_t)(self->cap - self->end), 0);
        Py_END_ALLOW_THREADS
        if (n == 0) {
            PyErr_SetString(PyExc_ConnectionError, "socket closed");
            return NULL;
        }
        if (n < 0) {
            if (errno == EINTR) {
                if (PyErr_CheckSignals() < 0)
                    return NULL;
                continue;
            }
            return PyErr_SetFromErrno(PyExc_OSError);
        }
        self->end += n;
    }
}

static PyObject *
decoder_pending(DecoderObject *self, PyObject *Py_UNUSED(ignored))
{
    return PyLong_FromSsize_t(self->end - self->start);
}

static PyMethodDef decoder_methods[] = {
    {"read_frame", (PyCFunction)decoder_read_frame, METH_O,
     "read_frame(fd) -> bytes: block until one full frame is available; "
     "raises ConnectionError on EOF."},
    {"pending", (PyCFunction)decoder_pending, METH_NOARGS,
     "Bytes buffered but not yet returned."},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject FrameDecoder_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "ray_tpu_torch.native._hotpath.FrameDecoder",
    .tp_basicsize = sizeof(DecoderObject),
    .tp_dealloc = (destructor)decoder_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Buffered length-prefixed frame reader over a socket fd.",
    .tp_methods = decoder_methods,
    .tp_new = decoder_new,
};

/* send_frame(fd, payload): writev([le32 length, payload]) with partial-write
 * handling — skips the Python-side header+payload concat copy. */
static PyObject *
hotpath_send_frame(PyObject *Py_UNUSED(mod), PyObject *args)
{
    int fd;
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "iy*", &fd, &view))
        return NULL;
    /* same ceiling the receiving FrameDecoder enforces — a larger frame
     * would be accepted here and then deterministically wedge the peer's
     * connection (the poisoned header stays buffered) */
    if (view.len > DECODER_MAX_FRAME) {
        PyBuffer_Release(&view);
        PyErr_Format(PyExc_OverflowError,
                     "frame length %zd exceeds max %zd",
                     view.len, (Py_ssize_t)DECODER_MAX_FRAME);
        return NULL;
    }
    char hdr[4];
    put_le32(hdr, (uint32_t)view.len);
    Py_ssize_t sent_hdr = 0, sent_body = 0;
    int saved_errno = 0;
    int failed = 0;
    Py_BEGIN_ALLOW_THREADS
    while (sent_hdr < 4 || sent_body < view.len) {
        struct iovec iov[2];
        int iovcnt = 0;
        if (sent_hdr < 4) {
            iov[iovcnt].iov_base = hdr + sent_hdr;
            iov[iovcnt].iov_len = (size_t)(4 - sent_hdr);
            iovcnt++;
        }
        if (sent_body < view.len) {
            iov[iovcnt].iov_base = (char *)view.buf + sent_body;
            iov[iovcnt].iov_len = (size_t)(view.len - sent_body);
            iovcnt++;
        }
        ssize_t n = writev(fd, iov, iovcnt);
        if (n < 0) {
            if (errno == EINTR)
                continue;
            saved_errno = errno;
            failed = 1;
            break;
        }
        if (sent_hdr < 4) {
            Py_ssize_t h = n < 4 - sent_hdr ? n : 4 - sent_hdr;
            sent_hdr += h;
            n -= h;
        }
        sent_body += n;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (failed) {
        errno = saved_errno;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    Py_RETURN_NONE;
}

static PyMethodDef hotpath_functions[] = {
    {"send_frame", hotpath_send_frame, METH_VARARGS,
     "send_frame(fd, payload): write one length-prefixed frame."},
    {NULL, NULL, 0, NULL},
};

/* ------------------------------------------------------------------ */
/* module                                                              */
/* ------------------------------------------------------------------ */

static struct PyModuleDef hotpath_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "_hotpath",
    .m_doc = "Native hot-path tier: C id types and frame codec.",
    .m_size = -1,
    .m_methods = hotpath_functions,
};

static int
add_id_type(PyObject *mod, IDType *t, const char *name)
{
    t->type.tp_base = &BaseID_Type;
    if (PyType_Ready(&t->type) < 0)
        return -1;
    PyObject *size = PyLong_FromLong(t->size);
    if (size == NULL)
        return -1;
    int rc = PyDict_SetItemString(t->type.tp_dict, "SIZE", size);
    Py_DECREF(size);
    if (rc < 0)
        return -1;
    PyType_Modified(&t->type);
    return PyModule_AddObjectRef(mod, name, (PyObject *)&t->type);
}

PyMODINIT_FUNC
PyInit__hotpath(void)
{
    if (PyType_Ready(&BaseID_Type) < 0 || PyType_Ready(&FrameDecoder_Type) < 0)
        return NULL;
    {
        uint64_t seed = 0;
        if (getrandom(&seed, sizeof(seed), 0) == (ssize_t)sizeof(seed))
            task_counter = seed >> 2;
    }
    {
        const char *env = getenv("RAY_TPU_MAX_FRAME_BYTES");
        if (env != NULL && env[0] != '\0') {
            char *endp = NULL;
            long long v = strtoll(env, &endp, 10);
            /* uint32 length prefix bounds the wire format at 4 GiB - 1 */
            if (endp != env && *endp == '\0' && v > 0 && v <= 0xffffffffLL)
                g_max_frame = (Py_ssize_t)v;
        }
    }
    PyObject *mod = PyModule_Create(&hotpath_module);
    if (mod == NULL)
        return NULL;
    if (PyModule_AddObjectRef(mod, "FrameDecoder", (PyObject *)&FrameDecoder_Type) < 0) {
        Py_DECREF(mod);
        return NULL;
    }
    if (PyModule_AddObjectRef(mod, "BaseID", (PyObject *)&BaseID_Type) < 0 ||
        add_id_type(mod, &JobID_Type, "JobID") < 0 ||
        add_id_type(mod, &NodeID_Type, "NodeID") < 0 ||
        add_id_type(mod, &WorkerID_Type, "WorkerID") < 0 ||
        add_id_type(mod, &ActorID_Type, "ActorID") < 0 ||
        add_id_type(mod, &TaskID_Type, "TaskID") < 0 ||
        add_id_type(mod, &ObjectID_Type, "ObjectID") < 0 ||
        add_id_type(mod, &PlacementGroupID_Type, "PlacementGroupID") < 0) {
        Py_DECREF(mod);
        return NULL;
    }
    return mod;
}
