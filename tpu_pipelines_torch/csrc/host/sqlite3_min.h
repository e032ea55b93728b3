// Minimal declarations for the stable SQLite3 C ABI.
//
// The port's copy of the JAX package's native/sqlite3_min.h.  Hosts often
// ship the runtime library (libsqlite3.so.0) but not the development
// header, so the subset of the public API used by metadata_core.cc is
// declared here.  These signatures are the documented,
// ABI-stable interface (https://sqlite.org/c3ref/intro.html) — unchanged
// since SQLite 3.x; ops/_build.py links the shared object directly.

#ifndef TPP_SQLITE3_MIN_H_
#define TPP_SQLITE3_MIN_H_

#include <cstdint>

extern "C" {

typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
typedef int64_t sqlite3_int64;

#define SQLITE_OK 0
#define SQLITE_ROW 100
#define SQLITE_DONE 101

// Destructor sentinel: make a private copy of bound text.
#define SQLITE_TRANSIENT ((void (*)(void*)) - 1)

int sqlite3_open(const char* filename, sqlite3** db);
int sqlite3_close(sqlite3* db);
int sqlite3_exec(sqlite3* db, const char* sql,
                 int (*callback)(void*, int, char**, char**), void* arg,
                 char** errmsg);
void sqlite3_free(void* p);
const char* sqlite3_errmsg(sqlite3* db);

int sqlite3_prepare_v2(sqlite3* db, const char* sql, int nbyte,
                       sqlite3_stmt** stmt, const char** tail);
int sqlite3_bind_text(sqlite3_stmt* stmt, int idx, const char* value, int n,
                      void (*destructor)(void*));
int sqlite3_bind_int64(sqlite3_stmt* stmt, int idx, sqlite3_int64 value);
int sqlite3_bind_double(sqlite3_stmt* stmt, int idx, double value);
int sqlite3_step(sqlite3_stmt* stmt);
int sqlite3_finalize(sqlite3_stmt* stmt);

int sqlite3_column_count(sqlite3_stmt* stmt);
int sqlite3_column_type(sqlite3_stmt* stmt, int col);
sqlite3_int64 sqlite3_column_int64(sqlite3_stmt* stmt, int col);
double sqlite3_column_double(sqlite3_stmt* stmt, int col);
const unsigned char* sqlite3_column_text(sqlite3_stmt* stmt, int col);

sqlite3_int64 sqlite3_last_insert_rowid(sqlite3* db);
int sqlite3_busy_timeout(sqlite3* db, int ms);

}  // extern "C"

#endif  // TPP_SQLITE3_MIN_H_
