// Fast OBJ mesh parsing (native data loader); a copy of the JAX package's
// csrc/meshio.cpp: source_tpu_torch builds it from its own sources.
//
// Counterpart of the reference's pure-Python OBJ importer
// (raysect/primitive/mesh/obj.py) for large assets: a two-pass C++
// tokenizer exposed over a C ABI for ctypes. Pass 1 counts records so the
// caller can allocate numpy buffers; pass 2 fills them. Polygon faces are
// fan-triangulated. Negative (relative) indices are resolved; normal ids
// are captured when present (v//vn or v/vt/vn).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Counts {
    int64_t vertices = 0;
    int64_t normals = 0;
    int64_t triangles = 0;  // after fan triangulation
};

bool starts(const char *line, const char *tag) {
    size_t n = std::strlen(tag);
    return std::strncmp(line, tag, n) == 0 &&
           (line[n] == ' ' || line[n] == '\t');
}

int face_vertex_count(const char *line) {
    // count whitespace-separated tokens after "f"
    const char *p = line + 1;
    int count = 0;
    bool in_tok = false;
    for (; *p && *p != '\n'; ++p) {
        if (std::isspace(static_cast<unsigned char>(*p))) {
            in_tok = false;
        } else if (!in_tok) {
            in_tok = true;
            ++count;
        }
    }
    return count;
}

}  // namespace

extern "C" {

// Pass 1: returns 0 on success and fills counts.
int obj_count(const char *path, int64_t *n_vertices, int64_t *n_normals,
              int64_t *n_triangles) {
    std::FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    Counts c;
    char line[65536];
    while (std::fgets(line, sizeof line, f)) {
        if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
            c.vertices++;
        } else if (line[0] == 'v' && line[1] == 'n') {
            c.normals++;
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            int nv = face_vertex_count(line);
            if (nv >= 3) c.triangles += nv - 2;
        }
    }
    std::fclose(f);
    *n_vertices = c.vertices;
    *n_normals = c.normals;
    *n_triangles = c.triangles;
    return 0;
}

// Pass 2: fills caller-allocated buffers sized from obj_count.
//   vertices  f32[n_vertices * 3]
//   normals   f32[n_normals * 3]
//   triangles i32[n_triangles * 3]
//   tri_normals i32[n_triangles * 3]  (-1 where absent)
// Returns 1 if every emitted triangle carried normal ids, else 0;
// negative on error.
int obj_read(const char *path, float *vertices, float *normals,
             int32_t *triangles, int32_t *tri_normals) {
    std::FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t vi = 0, ni = 0, ti = 0;
    bool all_normals = true;
    char line[65536];
    std::vector<int32_t> vid, nid;
    while (std::fgets(line, sizeof line, f)) {
        if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
            float x = 0, y = 0, z = 0;
            std::sscanf(line + 1, "%f %f %f", &x, &y, &z);
            vertices[3 * vi + 0] = x;
            vertices[3 * vi + 1] = y;
            vertices[3 * vi + 2] = z;
            ++vi;
        } else if (line[0] == 'v' && line[1] == 'n') {
            float x = 0, y = 0, z = 0;
            std::sscanf(line + 2, "%f %f %f", &x, &y, &z);
            normals[3 * ni + 0] = x;
            normals[3 * ni + 1] = y;
            normals[3 * ni + 2] = z;
            ++ni;
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            vid.clear();
            nid.clear();
            const char *p = line + 1;
            while (*p) {
                while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
                if (!*p || *p == '\n' || *p == '#') break;
                // token: v[/vt[/vn]]
                long v = std::strtol(p, const_cast<char **>(&p), 10);
                long n = 0;
                bool has_n = false;
                if (*p == '/') {
                    ++p;
                    if (*p == '/') {
                        ++p;
                        n = std::strtol(p, const_cast<char **>(&p), 10);
                        has_n = true;
                    } else {
                        std::strtol(p, const_cast<char **>(&p), 10);  // vt
                        if (*p == '/') {
                            ++p;
                            n = std::strtol(p, const_cast<char **>(&p), 10);
                            has_n = true;
                        }
                    }
                }
                int32_t v_res = v > 0 ? int32_t(v - 1) : int32_t(vi + v);
                int32_t n_res =
                    has_n ? (n > 0 ? int32_t(n - 1) : int32_t(ni + n)) : -1;
                vid.push_back(v_res);
                nid.push_back(n_res);
                while (*p && !std::isspace(static_cast<unsigned char>(*p))) ++p;
            }
            for (size_t k = 1; k + 1 < vid.size(); ++k) {
                triangles[3 * ti + 0] = vid[0];
                triangles[3 * ti + 1] = vid[k];
                triangles[3 * ti + 2] = vid[k + 1];
                tri_normals[3 * ti + 0] = nid[0];
                tri_normals[3 * ti + 1] = nid[k];
                tri_normals[3 * ti + 2] = nid[k + 1];
                if (nid[0] < 0 || nid[k] < 0 || nid[k + 1] < 0)
                    all_normals = false;
                ++ti;
            }
        }
    }
    std::fclose(f);
    return all_normals ? 1 : 0;
}

}  // extern "C"
