// Native host-side neighbor machinery for the MB-pol framework.
//
// Role: the reference implements its neighbor search in native code
// (OpenMM's computeNeighborListVoxelHash for pairs and the plugin's
// ReferenceThreeNeighborList for triplets). The jitted on-device list
// builder (ops/neighbors.py) is O(N^2) in distances, which is fine on an
// accelerator up to a few thousand molecules; this C++ voxel-hash builder is the O(N)
// host path used for very large systems and for capacity planning before
// compilation.
//
// Semantics match ops/neighbors.py (and deliberately *not* the reference's
// descending-index triplet enumeration, which drops two-edge triplets whose
// center has the largest molecule index - see ops/neighbors.py docstring):
//   - pairs: all i<j with minimum-image O-O distance < cutoff
//   - triplets: all unordered {a,b,c} with >= 2 edges, emitted once as
//     (i, center, k)
//
// C ABI for ctypes (ops/native.py). Returns the number found; writes at
// most `capacity` entries.

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelKey {
    int x, y, z;
    bool operator==(const VoxelKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct VoxelHashFn {
    size_t operator()(const VoxelKey& k) const {
        return (static_cast<size_t>(k.x) * 73856093u) ^
               (static_cast<size_t>(k.y) * 19349663u) ^
               (static_cast<size_t>(k.z) * 83492791u);
    }
};

inline double min_image(double d, double box) {
    if (box > 0.0) d -= std::floor(d / box + 0.5) * box;
    return d;
}

// Build per-atom adjacency (indices of neighbors within cutoff).
void build_adjacency(const double* pos, int64_t n, const double* box,
                     double cutoff, std::vector<std::vector<int64_t>>& adj) {
    adj.assign(n, {});
    const bool periodic = box != nullptr && box[0] > 0.0;
    const double c2 = cutoff * cutoff;

    double vx = cutoff, vy = cutoff, vz = cutoff;
    if (periodic) {
        // voxel edge that divides the box evenly (reference convention,
        // ReferenceThreeNeighborList.cpp:198-201)
        vx = box[0] / std::floor(box[0] / cutoff);
        vy = box[1] / std::floor(box[1] / cutoff);
        vz = box[2] / std::floor(box[2] / cutoff);
    }
    const int nx = periodic ? static_cast<int>(std::round(box[0] / vx)) : 0;
    const int ny = periodic ? static_cast<int>(std::round(box[1] / vy)) : 0;
    const int nz = periodic ? static_cast<int>(std::round(box[2] / vz)) : 0;

    std::unordered_map<VoxelKey, std::vector<int64_t>, VoxelHashFn> voxels;
    auto key_of = [&](const double* p) {
        return VoxelKey{static_cast<int>(std::floor(p[0] / vx)),
                        static_cast<int>(std::floor(p[1] / vy)),
                        static_cast<int>(std::floor(p[2] / vz))};
    };

    std::vector<VoxelKey> visited;
    for (int64_t i = 0; i < n; ++i) {
        const double* pi = pos + 3 * i;
        VoxelKey center = key_of(pi);
        visited.clear();
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    VoxelKey k{center.x + dx, center.y + dy, center.z + dz};
                    if (periodic) {
                        // with <= 2 voxels per dimension distinct offsets can
                        // alias to the same wrapped voxel; visit each once
                        k.x = ((k.x % nx) + nx) % nx;
                        k.y = ((k.y % ny) + ny) % ny;
                        k.z = ((k.z % nz) + nz) % nz;
                        bool seen = false;
                        for (const auto& v : visited)
                            if (v == k) { seen = true; break; }
                        if (seen) continue;
                        visited.push_back(k);
                    }
                    auto it = voxels.find(k);
                    if (it == voxels.end()) continue;
                    for (int64_t j : it->second) {
                        double ddx = min_image(pi[0] - pos[3 * j], periodic ? box[0] : 0);
                        double ddy = min_image(pi[1] - pos[3 * j + 1], periodic ? box[1] : 0);
                        double ddz = min_image(pi[2] - pos[3 * j + 2], periodic ? box[2] : 0);
                        if (ddx * ddx + ddy * ddy + ddz * ddz < c2) {
                            adj[i].push_back(j);
                            adj[j].push_back(i);
                        }
                    }
                }
        VoxelKey k = center;
        if (periodic) {
            k.x = ((k.x % nx) + nx) % nx;
            k.y = ((k.y % ny) + ny) % ny;
            k.z = ((k.z % nz) + nz) % nz;
        }
        voxels[k].push_back(i);
    }
}

}  // namespace

extern "C" {

int64_t mbpol_pair_list(const double* pos, int64_t n, const double* box,
                        double cutoff, int32_t* out, int64_t capacity) {
    std::vector<std::vector<int64_t>> adj;
    build_adjacency(pos, n, box, cutoff, adj);
    int64_t found = 0;
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j : adj[i])
            if (j > i) {
                if (found < capacity) {
                    out[2 * found] = static_cast<int32_t>(i);
                    out[2 * found + 1] = static_cast<int32_t>(j);
                }
                ++found;
            }
    return found;
}

int64_t mbpol_triplet_list(const double* pos, int64_t n, const double* box,
                           double cutoff, int32_t* out, int64_t capacity) {
    std::vector<std::vector<int64_t>> adj;
    build_adjacency(pos, n, box, cutoff, adj);
    // edge lookup for the triangle-dedup rule
    auto has_edge = [&](int64_t a, int64_t b) {
        const auto& na = adj[a];
        for (int64_t x : na)
            if (x == b) return true;
        return false;
    };
    int64_t found = 0;
    for (int64_t j = 0; j < n; ++j) {
        const auto& nb = adj[j];
        for (size_t p = 0; p < nb.size(); ++p)
            for (size_t q = 0; q < nb.size(); ++q) {
                int64_t a = nb[p], c = nb[q];
                if (a >= c) continue;
                // keep unless triangle with a smaller valid center (j < a
                // rule, matching ops/neighbors.py)
                if (has_edge(a, c) && !(j < a)) continue;
                if (found < capacity) {
                    out[3 * found] = static_cast<int32_t>(a);
                    out[3 * found + 1] = static_cast<int32_t>(j);
                    out[3 * found + 2] = static_cast<int32_t>(c);
                }
                ++found;
            }
    }
    return found;
}

}  // extern "C"
