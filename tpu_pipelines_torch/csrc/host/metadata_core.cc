// Native metadata-store core: the ml-metadata C++ equivalent.
//
// The port's copy of the JAX package's native/metadata_core.cc, built by
// tpu_pipelines_torch/ops/_build.py (g++, linked against the runtime
// libsqlite3) and bound with ctypes by
// tpu_pipelines_torch/metadata/native_store.py.  The storage engine —
// schema, prepared statements, transactions, row serialization — lives
// here; Python keeps only the composite logic (publish/cache/lineage) on
// top of these primitives, identically for both backends.  Beside the
// reference's ABI it has tpp_meta_get_contexts, so the native class also
// serves the context listing that resume and ``inspect runs`` read.
//
// Conventions of the ABI:
//   - every query returns a malloc'd JSON string; the caller frees it with
//     tpp_meta_free().  Property payloads arrive/leave as pre-serialized
//     JSON (the store treats them as opaque TEXT), so no JSON *parsing*
//     happens in C++ — only emission with correct string escaping.
//   - mutating ops return new row ids (>=1), 0 for ok-no-id, -1 on error;
//     tpp_meta_errmsg() returns the last error for a handle.
//   - query id/filter arguments: pass -1 for "no filter"; 0 is a real value
//     (the Python side's "unpersisted" sentinel) and matches nothing.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "sqlite3_min.h"

namespace {

// Must match tpu_pipelines_torch/metadata/store.py::_SCHEMA exactly, so the two
// backends are file-compatible (a store written by one opens in the other).
const char* kSchema = R"sql(
CREATE TABLE IF NOT EXISTS artifacts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type_name TEXT NOT NULL,
    uri TEXT NOT NULL,
    state TEXT NOT NULL,
    properties TEXT NOT NULL,
    fingerprint TEXT NOT NULL DEFAULT '',
    create_time REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_artifacts_type ON artifacts(type_name);
CREATE INDEX IF NOT EXISTS idx_artifacts_uri ON artifacts(uri);

CREATE TABLE IF NOT EXISTS executions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type_name TEXT NOT NULL,
    node_id TEXT NOT NULL,
    state TEXT NOT NULL,
    properties TEXT NOT NULL,
    cache_key TEXT NOT NULL DEFAULT '',
    create_time REAL NOT NULL,
    update_time REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_exec_cache ON executions(cache_key);
CREATE INDEX IF NOT EXISTS idx_exec_node ON executions(node_id);

CREATE TABLE IF NOT EXISTS events (
    artifact_id INTEGER NOT NULL,
    execution_id INTEGER NOT NULL,
    type TEXT NOT NULL,
    path TEXT NOT NULL DEFAULT '',
    idx INTEGER NOT NULL DEFAULT 0,
    ts REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_events_artifact ON events(artifact_id);
CREATE INDEX IF NOT EXISTS idx_events_execution ON events(execution_id);

CREATE TABLE IF NOT EXISTS contexts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type_name TEXT NOT NULL,
    name TEXT NOT NULL,
    properties TEXT NOT NULL,
    create_time REAL NOT NULL,
    UNIQUE(type_name, name)
);

CREATE TABLE IF NOT EXISTS associations (
    context_id INTEGER NOT NULL,
    execution_id INTEGER NOT NULL,
    UNIQUE(context_id, execution_id)
);

CREATE TABLE IF NOT EXISTS attributions (
    context_id INTEGER NOT NULL,
    artifact_id INTEGER NOT NULL,
    UNIQUE(context_id, artifact_id)
);
)sql";

struct Store {
  sqlite3* db = nullptr;
  std::string last_error;
};

void set_error(Store* s, const char* where) {
  s->last_error = std::string(where) + ": " + sqlite3_errmsg(s->db);
}

// ---------------------------------------------------------------- JSON out

void json_escape(const std::string& in, std::string* out) {
  out->push_back('"');
  for (unsigned char c : in) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\b': *out += "\\b"; break;
      case '\f': *out += "\\f"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof buf, "\\u%04x", c);
          *out += buf;
        } else {
          out->push_back(static_cast<char>(c));
        }
    }
  }
  out->push_back('"');
}

char* dup_cstr(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

// Serialize the current row of a stepped statement as a JSON object.
// Columns named in `raw_json_cols` are embedded verbatim (they hold
// pre-validated JSON written by this store).
void row_to_json(sqlite3_stmt* stmt, const std::vector<std::string>& names,
                 const std::vector<bool>& raw_json, std::string* out) {
  out->push_back('{');
  for (size_t i = 0; i < names.size(); ++i) {
    if (i) out->push_back(',');
    json_escape(names[i], out);
    out->push_back(':');
    int col = static_cast<int>(i);
    int type = sqlite3_column_type(stmt, col);
    if (type == 1) {  // SQLITE_INTEGER
      *out += std::to_string(sqlite3_column_int64(stmt, col));
    } else if (type == 2) {  // SQLITE_FLOAT
      char buf[32];
      std::snprintf(buf, sizeof buf, "%.17g", sqlite3_column_double(stmt, col));
      *out += buf;
    } else if (type == 5) {  // SQLITE_NULL
      *out += "null";
    } else {
      const unsigned char* text = sqlite3_column_text(stmt, col);
      std::string value = text ? reinterpret_cast<const char*>(text) : "";
      if (raw_json[i]) {
        *out += value.empty() ? "{}" : value;
      } else {
        json_escape(value, out);
      }
    }
  }
  out->push_back('}');
}

// Run a prepared query; serialize all rows into a JSON array string.
char* rows_json(Store* s, sqlite3_stmt* stmt,
                const std::vector<std::string>& names,
                const std::vector<bool>& raw_json) {
  std::string out = "[";
  bool first = true;
  int rc;
  while ((rc = sqlite3_step(stmt)) == SQLITE_ROW) {
    if (!first) out.push_back(',');
    first = false;
    row_to_json(stmt, names, raw_json, &out);
  }
  sqlite3_finalize(stmt);
  if (rc != SQLITE_DONE) {
    set_error(s, "step");
    return nullptr;
  }
  out.push_back(']');
  return dup_cstr(out);
}

bool bind_text(sqlite3_stmt* stmt, int idx, const char* value) {
  return sqlite3_bind_text(stmt, idx, value ? value : "", -1,
                           SQLITE_TRANSIENT) == SQLITE_OK;
}

sqlite3_stmt* prepare(Store* s, const char* sql) {
  sqlite3_stmt* stmt = nullptr;
  if (sqlite3_prepare_v2(s->db, sql, -1, &stmt, nullptr) != SQLITE_OK) {
    set_error(s, "prepare");
    return nullptr;
  }
  return stmt;
}

const std::vector<std::string> kArtifactCols = {
    "id", "type_name", "uri", "state", "properties", "fingerprint",
    "create_time"};
const std::vector<bool> kArtifactRaw = {false, false, false, false,
                                        true,  false, false};
const std::vector<std::string> kExecutionCols = {
    "id", "type_name", "node_id", "state", "properties", "cache_key",
    "create_time", "update_time"};
const std::vector<bool> kExecutionRaw = {false, false, false, false,
                                         true,  false, false, false};
const std::vector<std::string> kEventCols = {
    "artifact_id", "execution_id", "type", "path", "idx", "ts"};
const std::vector<bool> kEventRaw = {false, false, false, false, false, false};
const std::vector<std::string> kContextCols = {
    "id", "type_name", "name", "properties", "create_time"};
const std::vector<bool> kContextRaw = {false, false, false, true, false};

}  // namespace

extern "C" {

void* tpp_meta_open(const char* path) {
  Store* s = new Store();
  if (sqlite3_open(path, &s->db) != SQLITE_OK) {
    sqlite3_close(s->db);  // SQLite allocates the handle even on failure
    delete s;
    return nullptr;
  }
  // Match the Python backend's sqlite3.connect default lock patience.
  sqlite3_busy_timeout(s->db, 5000);
  char* err = nullptr;
  if (std::strcmp(path, ":memory:") != 0) {
    sqlite3_exec(s->db, "PRAGMA journal_mode=WAL", nullptr, nullptr, nullptr);
  }
  sqlite3_exec(s->db, "PRAGMA foreign_keys=ON", nullptr, nullptr, nullptr);
  if (sqlite3_exec(s->db, kSchema, nullptr, nullptr, &err) != SQLITE_OK) {
    if (err) sqlite3_free(err);
    sqlite3_close(s->db);
    delete s;
    return nullptr;
  }
  return s;
}

void tpp_meta_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return;
  sqlite3_close(s->db);
  delete s;
}

const char* tpp_meta_errmsg(void* handle) {
  return static_cast<Store*>(handle)->last_error.c_str();
}

void tpp_meta_free(char* p) { std::free(p); }

int tpp_meta_exec(void* handle, const char* sql) {
  Store* s = static_cast<Store*>(handle);
  char* err = nullptr;
  if (sqlite3_exec(s->db, sql, nullptr, nullptr, &err) != SQLITE_OK) {
    s->last_error = err ? err : "exec failed";
    if (err) sqlite3_free(err);
    return -1;
  }
  return 0;
}

// ------------------------------------------------------------- artifacts

int64_t tpp_meta_put_artifact(void* handle, int64_t id, const char* type_name,
                              const char* uri, const char* state,
                              const char* properties, const char* fingerprint,
                              double create_time) {
  Store* s = static_cast<Store*>(handle);
  sqlite3_stmt* stmt;
  if (id > 0) {
    stmt = prepare(s,
                   "UPDATE artifacts SET type_name=?1, uri=?2, state=?3, "
                   "properties=?4, fingerprint=?5, create_time=?6 WHERE id=?7");
    if (!stmt) return -1;
    sqlite3_bind_int64(stmt, 7, id);
  } else {
    stmt = prepare(s,
                   "INSERT INTO artifacts (type_name, uri, state, properties, "
                   "fingerprint, create_time) VALUES (?1,?2,?3,?4,?5,?6)");
    if (!stmt) return -1;
  }
  bind_text(stmt, 1, type_name);
  bind_text(stmt, 2, uri);
  bind_text(stmt, 3, state);
  bind_text(stmt, 4, properties);
  bind_text(stmt, 5, fingerprint);
  sqlite3_bind_double(stmt, 6, create_time);
  int rc = sqlite3_step(stmt);
  sqlite3_finalize(stmt);
  if (rc != SQLITE_DONE) {
    set_error(s, "put_artifact");
    return -1;
  }
  return id > 0 ? id : sqlite3_last_insert_rowid(s->db);
}

char* tpp_meta_get_artifacts(void* handle, const char* type_name,
                             const char* state, const char* uri, int64_t id) {
  Store* s = static_cast<Store*>(handle);
  std::string sql = "SELECT id, type_name, uri, state, properties, "
                    "fingerprint, create_time FROM artifacts WHERE 1=1";
  if (id >= 0) sql += " AND id=?4";
  if (type_name && *type_name) sql += " AND type_name=?1";
  if (state && *state) sql += " AND state=?2";
  if (uri && *uri) sql += " AND uri=?3";
  sql += " ORDER BY id";
  sqlite3_stmt* stmt = prepare(s, sql.c_str());
  if (!stmt) return nullptr;
  if (type_name && *type_name) bind_text(stmt, 1, type_name);
  if (state && *state) bind_text(stmt, 2, state);
  if (uri && *uri) bind_text(stmt, 3, uri);
  if (id >= 0) sqlite3_bind_int64(stmt, 4, id);
  return rows_json(s, stmt, kArtifactCols, kArtifactRaw);
}

// ------------------------------------------------------------ executions

int64_t tpp_meta_put_execution(void* handle, int64_t id, const char* type_name,
                               const char* node_id, const char* state,
                               const char* properties, const char* cache_key,
                               double create_time, double update_time) {
  Store* s = static_cast<Store*>(handle);
  sqlite3_stmt* stmt;
  if (id > 0) {
    stmt = prepare(s,
                   "UPDATE executions SET type_name=?1, node_id=?2, state=?3, "
                   "properties=?4, cache_key=?5, create_time=?6, "
                   "update_time=?7 WHERE id=?8");
    if (!stmt) return -1;
    sqlite3_bind_int64(stmt, 8, id);
  } else {
    stmt = prepare(s,
                   "INSERT INTO executions (type_name, node_id, state, "
                   "properties, cache_key, create_time, update_time) "
                   "VALUES (?1,?2,?3,?4,?5,?6,?7)");
    if (!stmt) return -1;
  }
  bind_text(stmt, 1, type_name);
  bind_text(stmt, 2, node_id);
  bind_text(stmt, 3, state);
  bind_text(stmt, 4, properties);
  bind_text(stmt, 5, cache_key);
  sqlite3_bind_double(stmt, 6, create_time);
  sqlite3_bind_double(stmt, 7, update_time);
  int rc = sqlite3_step(stmt);
  sqlite3_finalize(stmt);
  if (rc != SQLITE_DONE) {
    set_error(s, "put_execution");
    return -1;
  }
  return id > 0 ? id : sqlite3_last_insert_rowid(s->db);
}

char* tpp_meta_get_executions(void* handle, const char* node_id,
                              const char* state, int64_t id) {
  Store* s = static_cast<Store*>(handle);
  std::string sql = "SELECT id, type_name, node_id, state, properties, "
                    "cache_key, create_time, update_time FROM executions "
                    "WHERE 1=1";
  if (id >= 0) sql += " AND id=?3";
  if (node_id && *node_id) sql += " AND node_id=?1";
  if (state && *state) sql += " AND state=?2";
  sql += " ORDER BY id";
  sqlite3_stmt* stmt = prepare(s, sql.c_str());
  if (!stmt) return nullptr;
  if (node_id && *node_id) bind_text(stmt, 1, node_id);
  if (state && *state) bind_text(stmt, 2, state);
  if (id >= 0) sqlite3_bind_int64(stmt, 3, id);
  return rows_json(s, stmt, kExecutionCols, kExecutionRaw);
}

// ---------------------------------------------------------------- events

int tpp_meta_put_event(void* handle, int64_t artifact_id, int64_t execution_id,
                       const char* type, const char* path, int64_t idx,
                       double ts) {
  Store* s = static_cast<Store*>(handle);
  sqlite3_stmt* stmt = prepare(
      s, "INSERT INTO events (artifact_id, execution_id, type, path, idx, ts) "
         "VALUES (?1,?2,?3,?4,?5,?6)");
  if (!stmt) return -1;
  sqlite3_bind_int64(stmt, 1, artifact_id);
  sqlite3_bind_int64(stmt, 2, execution_id);
  bind_text(stmt, 3, type);
  bind_text(stmt, 4, path);
  sqlite3_bind_int64(stmt, 5, idx);
  sqlite3_bind_double(stmt, 6, ts);
  int rc = sqlite3_step(stmt);
  sqlite3_finalize(stmt);
  if (rc != SQLITE_DONE) {
    set_error(s, "put_event");
    return -1;
  }
  return 0;
}

char* tpp_meta_get_events(void* handle, int64_t artifact_id,
                          int64_t execution_id) {
  Store* s = static_cast<Store*>(handle);
  std::string sql = "SELECT artifact_id, execution_id, type, path, idx, ts "
                    "FROM events WHERE 1=1";
  if (artifact_id >= 0) sql += " AND artifact_id=?1";
  if (execution_id >= 0) sql += " AND execution_id=?2";
  sql += " ORDER BY rowid";
  sqlite3_stmt* stmt = prepare(s, sql.c_str());
  if (!stmt) return nullptr;
  if (artifact_id >= 0) sqlite3_bind_int64(stmt, 1, artifact_id);
  if (execution_id >= 0) sqlite3_bind_int64(stmt, 2, execution_id);
  return rows_json(s, stmt, kEventCols, kEventRaw);
}

// -------------------------------------------------------------- contexts

int64_t tpp_meta_put_context(void* handle, const char* type_name,
                             const char* name, const char* properties,
                             double create_time) {
  Store* s = static_cast<Store*>(handle);
  sqlite3_stmt* stmt = prepare(
      s, "SELECT id FROM contexts WHERE type_name=?1 AND name=?2");
  if (!stmt) return -1;
  bind_text(stmt, 1, type_name);
  bind_text(stmt, 2, name);
  int rc = sqlite3_step(stmt);
  if (rc == SQLITE_ROW) {
    int64_t id = sqlite3_column_int64(stmt, 0);
    sqlite3_finalize(stmt);
    return id;
  }
  sqlite3_finalize(stmt);
  stmt = prepare(s,
                 "INSERT INTO contexts (type_name, name, properties, "
                 "create_time) VALUES (?1,?2,?3,?4)");
  if (!stmt) return -1;
  bind_text(stmt, 1, type_name);
  bind_text(stmt, 2, name);
  bind_text(stmt, 3, properties);
  sqlite3_bind_double(stmt, 4, create_time);
  rc = sqlite3_step(stmt);
  sqlite3_finalize(stmt);
  if (rc != SQLITE_DONE) {
    set_error(s, "put_context");
    return -1;
  }
  return sqlite3_last_insert_rowid(s->db);
}

char* tpp_meta_get_context(void* handle, const char* type_name,
                           const char* name) {
  Store* s = static_cast<Store*>(handle);
  sqlite3_stmt* stmt = prepare(
      s, "SELECT id, type_name, name, properties, create_time FROM contexts "
         "WHERE type_name=?1 AND name=?2");
  if (!stmt) return nullptr;
  bind_text(stmt, 1, type_name);
  bind_text(stmt, 2, name);
  return rows_json(s, stmt, kContextCols, kContextRaw);
}

char* tpp_meta_get_contexts(void* handle, const char* type_name) {
  Store* s = static_cast<Store*>(handle);
  const bool all = type_name == nullptr || type_name[0] == '\0';
  sqlite3_stmt* stmt = prepare(
      s, all ? "SELECT id, type_name, name, properties, create_time "
               "FROM contexts ORDER BY id"
             : "SELECT id, type_name, name, properties, create_time "
               "FROM contexts WHERE type_name=?1 ORDER BY id");
  if (!stmt) return nullptr;
  if (!all) bind_text(stmt, 1, type_name);
  return rows_json(s, stmt, kContextCols, kContextRaw);
}

int tpp_meta_link(void* handle, const char* table, int64_t context_id,
                  int64_t other_id) {
  Store* s = static_cast<Store*>(handle);
  const char* sql;
  if (std::strcmp(table, "associations") == 0) {
    sql = "INSERT OR IGNORE INTO associations (context_id, execution_id) "
          "VALUES (?1,?2)";
  } else if (std::strcmp(table, "attributions") == 0) {
    sql = "INSERT OR IGNORE INTO attributions (context_id, artifact_id) "
          "VALUES (?1,?2)";
  } else {
    s->last_error = "unknown link table";
    return -1;
  }
  sqlite3_stmt* stmt = prepare(s, sql);
  if (!stmt) return -1;
  sqlite3_bind_int64(stmt, 1, context_id);
  sqlite3_bind_int64(stmt, 2, other_id);
  int rc = sqlite3_step(stmt);
  sqlite3_finalize(stmt);
  if (rc != SQLITE_DONE) {
    set_error(s, "link");
    return -1;
  }
  return 0;
}

char* tpp_meta_by_context(void* handle, const char* what, int64_t context_id) {
  Store* s = static_cast<Store*>(handle);
  if (std::strcmp(what, "executions") == 0) {
    sqlite3_stmt* stmt = prepare(
        s, "SELECT e.id, e.type_name, e.node_id, e.state, e.properties, "
           "e.cache_key, e.create_time, e.update_time FROM executions e "
           "JOIN associations a ON a.execution_id = e.id "
           "WHERE a.context_id=?1 ORDER BY e.id");
    if (!stmt) return nullptr;
    sqlite3_bind_int64(stmt, 1, context_id);
    return rows_json(s, stmt, kExecutionCols, kExecutionRaw);
  }
  sqlite3_stmt* stmt = prepare(
      s, "SELECT ar.id, ar.type_name, ar.uri, ar.state, ar.properties, "
         "ar.fingerprint, ar.create_time FROM artifacts ar "
         "JOIN attributions at ON at.artifact_id = ar.id "
         "WHERE at.context_id=?1 ORDER BY ar.id");
  if (!stmt) return nullptr;
  sqlite3_bind_int64(stmt, 1, context_id);
  return rows_json(s, stmt, kArtifactCols, kArtifactRaw);
}

// ---------------------------------------------------------- cache lookup

int64_t tpp_meta_latest_cached_execution(void* handle, const char* cache_key,
                                         const char* complete_state) {
  Store* s = static_cast<Store*>(handle);
  sqlite3_stmt* stmt = prepare(
      s, "SELECT id FROM executions WHERE cache_key=?1 AND state=?2 "
         "ORDER BY id DESC LIMIT 1");
  if (!stmt) return -1;
  bind_text(stmt, 1, cache_key);
  bind_text(stmt, 2, complete_state);
  int rc = sqlite3_step(stmt);
  int64_t id = 0;
  if (rc == SQLITE_ROW) {
    id = sqlite3_column_int64(stmt, 0);
  } else if (rc != SQLITE_DONE) {
    set_error(s, "cache_lookup");
    id = -1;
  }
  sqlite3_finalize(stmt);
  return id;
}

}  // extern "C"
