#!/usr/bin/env python
"""Extract MB-pol physics parameter tables from the reference C++ headers.

The reference hard-codes the fitted MB-pol parameter tables (Partridge-Schwenke
monomer PES coefficients, 2-body/3-body polynomial fit coefficients, dipole
moment surface coefficients, Thole/switching constants) as C arrays:

  - platforms/reference/src/mbpol_interaction_constants.h  (1-body PES tables)
  - platforms/reference/src/mbpol_2body_constants.h        (2-body k-params + 1153 fit coeffs)
  - platforms/reference/src/mbpol_3body_constants.h        (3-body k/d-params + 1163 fit coeffs)
  - platforms/reference/src/MBPolReferenceElectrostaticsForce.cpp (84-term DMS, in computeWaterCharge)

These are *data* (physics fit parameters), not code.  This script parses them
into .npz archives consumed by the framework at import time, so the
framework itself is standalone.

Usage: python tools/extract_constants.py [--reference /root/reference] [--out mbpol_openmm_plugin_tpu/data]
"""
import argparse
import re
import os
import numpy as np

FLOAT_RE = r'[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?'


def parse_scalar(text, name):
    m = re.search(r'const\s+double\s+%s\s*=\s*(%s)\s*;' % (re.escape(name), FLOAT_RE), text)
    if not m:
        raise ValueError("scalar %s not found" % name)
    return float(m.group(1))


def parse_array(text, name, dtype=float):
    m = re.search(r'const\s+(?:double|size_t)\s+%s\s*\[\s*\d*\s*\]\s*=\s*\{(.*?)\};' % re.escape(name),
                  text, re.S)
    if not m:
        raise ValueError("array %s not found" % name)
    body = re.sub(r'//[^\n]*', '', m.group(1))
    vals = [dtype(v) for v in re.findall(FLOAT_RE, body)]
    return np.array(vals)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reference', default='/root/reference')
    ap.add_argument('--out', default=os.path.join(os.path.dirname(__file__), '..',
                                                  'mbpol_openmm_plugin_tpu', 'data'))
    args = ap.parse_args()
    src = os.path.join(args.reference, 'platforms', 'reference', 'src')
    os.makedirs(args.out, exist_ok=True)

    # ------------------------------------------------------------------
    # 1-body (Partridge-Schwenke PES): mbpol_interaction_constants.h
    # ------------------------------------------------------------------
    with open(os.path.join(src, 'mbpol_interaction_constants.h')) as f:
        t = f.read()
    onebody = dict(
        c5zA=parse_array(t, 'c5zA'),
        cbasis=parse_array(t, 'cbasis'),
        ccore=parse_array(t, 'ccore'),
        crest=parse_array(t, 'crest'),
        idx1=parse_array(t, 'idx1', int),
        idx2=parse_array(t, 'idx2', int),
        idx3=parse_array(t, 'idx3', int),
    )
    for s in ['reoh', 'thetae', 'b1', 'roh', 'alphaoh', 'deohA', 'phh1A', 'phh2']:
        onebody[s] = parse_scalar(t, s)
    # derived unit constants (CODATA 2010, as in the reference header)
    Eh_J = 4.35974434e-18
    Na = 6.02214129e+23
    kcal_J = 4184.0
    c0 = 299792458.0
    h_Js = 6.62606957e-34
    Eh_kcalmol = Eh_J * Na / kcal_J
    Eh_cm1 = 1.0e-2 * Eh_J / (c0 * h_Js)
    onebody['cm1_kcalmol'] = Eh_kcalmol / Eh_cm1
    for n, arr in [('c5zA', 245), ('idx1', 245)]:
        assert onebody[n].shape == (arr,), (n, onebody[n].shape)
    np.savez(os.path.join(args.out, 'onebody.npz'), **onebody)

    # ------------------------------------------------------------------
    # 2-body constants
    # ------------------------------------------------------------------
    with open(os.path.join(src, 'mbpol_2body_constants.h')) as f:
        t = f.read()
    two = dict(thefit=parse_array(t, 'thefit'))
    for s in ['k_HH_intra', 'k_OH_intra', 'k_HH_coul', 'k_OH_coul', 'k_OO_coul',
              'k_XH_main', 'k_XO_main', 'k_XX_main', 'in_plane_gamma',
              'out_of_plane_gamma', 'r2i', 'r2f']:
        two[s] = parse_scalar(t, s)
    assert two['thefit'].shape == (1153,), two['thefit'].shape
    np.savez(os.path.join(args.out, 'twobody_constants.npz'), **two)

    # ------------------------------------------------------------------
    # 3-body constants
    # ------------------------------------------------------------------
    with open(os.path.join(src, 'mbpol_3body_constants.h')) as f:
        t = f.read()
    three = dict(thefit=parse_array(t, 'thefit'))
    for s in ['r3i', 'r3f', 'kHH_intra', 'kOH_intra', 'kHH', 'kOH', 'kOO',
              'dHH_intra', 'dOH_intra', 'dHH', 'dOH', 'dOO']:
        three[s] = parse_scalar(t, s)
    assert three['thefit'].shape == (1163,), three['thefit'].shape
    np.savez(os.path.join(args.out, 'threebody_constants.npz'), **three)

    # ------------------------------------------------------------------
    # Dipole moment surface (computeWaterCharge, 84 terms)
    # ------------------------------------------------------------------
    with open(os.path.join(src, 'MBPolReferenceElectrostaticsForce.cpp')) as f:
        t = f.read()
    dms = dict(
        idxD0=parse_array(t, 'idxD0', int),
        idxD1=parse_array(t, 'idxD1', int),
        idxD2=parse_array(t, 'idxD2', int),
        coefD=parse_array(t, 'coefD'),
    )
    assert dms['coefD'].shape == (84,)
    np.savez(os.path.join(args.out, 'dms.npz'), **dms)

    # ------------------------------------------------------------------
    # Force-field parameters from python/mbpol.xml: dispersion C6/d6 tables
    # (embedded <Script>, mbpol.xml:52-83), Thole parameters (:22), per-type
    # charge/damping/polarizability (:24-26), virtual-site weights (:14),
    # cutoffs (:31,:34), masses (:3-6).
    # ------------------------------------------------------------------
    with open(os.path.join(args.reference, 'python', 'mbpol.xml')) as f:
        xml = f.read()

    def xml_table(name, n=16):
        m = re.search(r'%s\s*=\s*\[(.*?)\]' % name, xml, re.S)
        body = re.sub(r'#[^\n]*', '', m.group(1))
        vals = [float(v) for v in re.findall(FLOAT_RE, body)]
        assert len(vals) == n, (name, len(vals))
        return np.array(vals).reshape(4, 4)

    def xml_attr(attr):
        return float(re.search(r'%s="(%s)"' % (attr, FLOAT_RE), xml).group(1))

    thole_map = {}
    for key in ['thole-charge-charge', 'thole-charge-dipole', 'thole-dipole-dipole',
                'thole-dipole-dipole-singlebond']:
        thole_map[key] = xml_attr(key)
    # order TCC, TCD, TDD, TDDOH, TDDHH (mbpol.py:266: TDDHH reuses
    # 'thole-dipole-dipole')
    thole = np.array([thole_map['thole-charge-charge'],
                      thole_map['thole-charge-dipole'],
                      thole_map['thole-dipole-dipole'],
                      thole_map['thole-dipole-dipole-singlebond'],
                      thole_map['thole-dipole-dipole']])

    def atom_params(tname):
        m = re.search(r'<Atom type="%s" charge="(%s)" damping-factor="(%s)" '
                      r'polarizability="(%s)"' % (tname, FLOAT_RE, FLOAT_RE, FLOAT_RE), xml)
        return [float(m.group(i)) for i in (1, 2, 3)]

    o_p, h_p, m_p = atom_params('MBPol-O'), atom_params('MBPol-H'), atom_params('MBPol-M')
    vs = re.search(r'VirtualSite type="average3".*?weight1="(%s)" weight2="(%s)" '
                   r'weight3="(%s)"' % (FLOAT_RE, FLOAT_RE, FLOAT_RE), xml)
    masses = {}
    for tname, cls in [('MBPol-O', 'O'), ('MBPol-H', 'H'), ('MBPol-M', 'M'), ('MBPol-Cl', 'CL')]:
        m = re.search(r'<Type name="%s"[^>]*mass="(%s)"' % (tname, FLOAT_RE), xml)
        masses[cls] = float(m.group(1))

    ff = dict(
        C6=xml_table('C6table'),            # kJ/mol nm^6, class order O,H,M,Cl
        d6=xml_table('d6table'),            # nm^-1
        thole=thole,
        # per-type [charge, damping_factor, polarizability] O/H/M
        atom_O=np.array(o_p), atom_H=np.array(h_p), atom_M=np.array(m_p),
        vsite_weights=np.array([float(vs.group(i)) for i in (1, 2, 3)]),
        cutoff_2b=float(re.search(r'MBPolTwoBodyForce cutoff_nm="(%s)"' % FLOAT_RE, xml).group(1)),
        cutoff_3b=float(re.search(r'MBPolThreeBodyForce cutoff_nm="(%s)"' % FLOAT_RE, xml).group(1)),
        mass_O=masses['O'], mass_H=masses['H'], mass_M=masses['M'], mass_Cl=masses['CL'],
    )
    np.savez(os.path.join(args.out, 'forcefield.npz'), **ff)

    print("wrote parameter archives to", args.out)


if __name__ == '__main__':
    main()
