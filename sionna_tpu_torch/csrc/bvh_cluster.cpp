// Triangle clustering for the ray tracer's acceleration structure.
//
// The device-side traversal in ``sionna_tpu_torch/rt/accel.py`` uses
// dense cluster culling: triangles are grouped into spatially coherent,
// fixed-size clusters whose AABBs are slab-tested in bulk, and only the
// clusters a ray enters are Moller-Trumbore tested.
//
// This file is the host-side builder: a recursive median split over
// triangle centroids (longest axis, nth_element) that emits a
// permutation grouping every ``cluster_size`` consecutive triangles into
// one tight cluster. Left split sizes are rounded to multiples of the
// cluster size, so that at most ONE ragged (padded) cluster exists.
//
// Built with ``g++ -O3 -shared -fPIC`` on first use and loaded with
// ctypes (``sionna_tpu_torch/_build.py``, ``HostLibrary``); a NumPy
// version of the same algorithm lives in accel.py.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Item {
    float c[3];    // centroid
    int32_t id;    // original triangle index
};

// Recursive longest-axis median split; leaves of size <= cluster_size
// are emitted in DFS order. left_n is rounded down to a multiple of
// cluster_size (and clamped to >= cluster_size), so raggedness
// propagates to the global tail only.
void split(Item* items, int64_t n, int32_t cluster_size,
           int32_t* out, int64_t& cursor) {
    if (n <= cluster_size) {
        for (int64_t i = 0; i < n; ++i) out[cursor++] = items[i].id;
        return;
    }
    float lo[3] = {items[0].c[0], items[0].c[1], items[0].c[2]};
    float hi[3] = {lo[0], lo[1], lo[2]};
    for (int64_t i = 1; i < n; ++i) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], items[i].c[a]);
            hi[a] = std::max(hi[a], items[i].c[a]);
        }
    }
    int axis = 0;
    float ext = hi[0] - lo[0];
    for (int a = 1; a < 3; ++a) {
        if (hi[a] - lo[a] > ext) { ext = hi[a] - lo[a]; axis = a; }
    }
    int64_t left_n = (n / 2 / cluster_size) * (int64_t)cluster_size;
    if (left_n < cluster_size) left_n = cluster_size;
    if (left_n >= n) left_n = n - 1;
    std::nth_element(items, items + left_n, items + n,
                     [axis](const Item& x, const Item& y) {
                         return x.c[axis] < y.c[axis];
                     });
    split(items, left_n, cluster_size, out, cursor);
    split(items + left_n, n - left_n, cluster_size, out, cursor);
}

}  // namespace

extern "C" {

// tris: [num_tri, 3, 3] float32 vertex array (row-major)
// perm (out): [num_tri] int32 -- tris[perm] is the clustered order
void sionna_bvh_cluster(const float* tris, int64_t num_tri,
                        int32_t cluster_size, int32_t* perm) {
    std::vector<Item> items(num_tri);
    for (int64_t i = 0; i < num_tri; ++i) {
        const float* v = tris + 9 * i;
        items[i].c[0] = (v[0] + v[3] + v[6]) / 3.0f;
        items[i].c[1] = (v[1] + v[4] + v[7]) / 3.0f;
        items[i].c[2] = (v[2] + v[5] + v[8]) / 3.0f;
        items[i].id = (int32_t)i;
    }
    int64_t cursor = 0;
    split(items.data(), num_tri, cluster_size, perm, cursor);
}

}  // extern "C"
