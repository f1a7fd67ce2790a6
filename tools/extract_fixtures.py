#!/usr/bin/env python
"""Extract the reference test geometries (PDB fixtures) into npz archives.

The golden energies in the reference test-suite are computed from the PDB
coordinates (3 decimals, Angstrom), so tests of this framework must use
bit-identical geometries. Fixtures are stored as npz (positions in nm plus
atom metadata); tests/round-trips regenerate PDB text with our own writer.
"""
import os
import re
import numpy as np

REF = '/root/reference/python/tests/pdb_files'
EXTRA = {'water3_cluster': '/root/reference/python/water3.pdb',
         'water14_cluster': '/root/reference/python/water14_cluster.pdb',
         'water256_bulk': '/root/reference/python/water256_bulk.pdb'}
OUT = os.path.join(os.path.dirname(__file__), '..', 'tests', 'fixtures')


def parse_pdb(path):
    names, resnames, resids, pos = [], [], [], []
    box = None
    with open(path) as f:
        for line in f:
            if line.startswith(('ATOM', 'HETATM')):
                names.append(line[12:16].strip())
                resnames.append(line[17:21].strip())
                resids.append(int(line[22:26]))
                pos.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
            elif line.startswith('CRYST1'):
                box = [float(line[6:15]), float(line[15:24]), float(line[24:33])]
    return dict(
        names=np.array(names), resnames=np.array(resnames),
        resids=np.array(resids, np.int32),
        positions=np.array(pos) * 0.1,  # Angstrom -> nm
        box=np.array(box) * 0.1 if box else np.zeros(3))


def main():
    os.makedirs(OUT, exist_ok=True)
    for fn in sorted(os.listdir(REF)):
        if fn.endswith('.pdb'):
            d = parse_pdb(os.path.join(REF, fn))
            np.savez(os.path.join(OUT, fn[:-4] + '.npz'), **d)
            print(fn, len(d['names']), 'atoms')
    for name, path in EXTRA.items():
        d = parse_pdb(path)
        np.savez(os.path.join(OUT, name + '.npz'), **d)
        print(name, len(d['names']), 'atoms', 'box', d['box'])


if __name__ == '__main__':
    main()
