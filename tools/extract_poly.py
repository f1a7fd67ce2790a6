#!/usr/bin/env python
"""Extract the MB-pol 2-body/3-body polynomials as data (exponents + coefficients).

The reference evaluates its permutationally-invariant polynomials with
machine-generated straight-line C++ (poly-2b-v6x.cpp: 13.8k LoC, 1153 linear
fit coefficients over 31 variables; poly-3b-v2x.cpp: 28.4k LoC, 1163 coeffs
over 36 variables).  That form is hostile to accelerators.  Here we recover the
underlying mathematical object - a sparse polynomial

    E(x) = sum_m  c_m * prod_i x_i^{e_mi},      c_m = sum_k w_mk * a_k

by parsing the generated code into an expression DAG and symbolically
expanding the energy expression.  The result is stored as:

    exponents : (n_mono, nvars) small-int matrix
    coeffs    : (n_mono,) float64, already contracted with the fit vector a

At runtime the polynomial and its gradient are then two matmuls
(see mbpol_openmm_plugin_tpu/ops/polyeval.py), which map onto matrix units.

The extraction is validated exactly: the original C++ file is compiled to a
shared library and compared against the expanded form at random points
(agreement to ~1e-12 relative).

Grammar of the generated code (verified over both files):
    const double tN = EXPR;
    df[K] = EXPR;
    g[I] = EXPR;          (gradients - not needed, we differentiate the data form)
    return EXPR;
    EXPR := TERM (+ TERM)* ;  TERM := FACTOR (* FACTOR)*
    FACTOR := FLOAT | tN | df[K] | a[K] | x[K] | ( EXPR )
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import numpy as np

TOKEN_RE = re.compile(r'\s*(?:(?P<num>[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)'
                      r'|(?P<name>[A-Za-z_][A-Za-z_0-9]*)'
                      r'|(?P<idx>\[\s*[0-9]+\s*\])'
                      r'|(?P<op>[-+*()]))')


def tokenize(expr):
    pos, out = 0, []
    while pos < len(expr):
        m = TOKEN_RE.match(expr, pos)
        if not m:
            raise ValueError('bad token at %r' % expr[pos:pos + 40])
        pos = m.end()
        if m.group('num') is not None:
            out.append(('num', float(m.group('num'))))
        elif m.group('name') is not None:
            out.append(('name', m.group('name')))
        elif m.group('idx') is not None:
            out.append(('idx', int(m.group('idx').strip('[] '))))
        else:
            out.append(('op', m.group('op')))
    return out


# ----------------------------------------------------------------------
# Sparse polynomial algebra.
# A polynomial is dict: monokey -> linear form; linear form is dict: aidx -> float
# monokey is a sorted tuple of (var, exp); aidx -1 denotes the constant term.
# ----------------------------------------------------------------------

def padd(p, q):
    if len(q) > len(p):
        p, q = q, p
    r = dict(p)
    for mono, lin in q.items():
        if mono in r:
            merged = dict(r[mono])
            for k, v in lin.items():
                merged[k] = merged.get(k, 0.0) + v
            r[mono] = merged
        else:
            r[mono] = lin
    return r


def is_const_coeffs(p):
    return all(set(lin) <= {-1} for lin in p.values())


def pmul(p, q):
    if not is_const_coeffs(q):
        if not is_const_coeffs(p):
            raise ValueError('product of two a-dependent polynomials (nonlinear in a)')
        p, q = q, p
    # q has constant coefficients only
    r = {}
    for mq, lq in q.items():
        cq = lq[-1]
        dq = dict(mq)
        for mp, lp in p.items():
            d = dict(dq)
            for var, e in mp:
                d[var] = d.get(var, 0) + e
            mono = tuple(sorted(d.items()))
            lin = {k: v * cq for k, v in lp.items()}
            if mono in r:
                merged = r[mono]
                for k, v in lin.items():
                    merged[k] = merged.get(k, 0.0) + v
            else:
                r[mono] = lin
    return r


class Parser:
    def __init__(self, tokens, env):
        self.toks = tokens
        self.pos = 0
        self.env = env

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else (None, None)

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def parse_expr(self):
        neg = False
        if self.peek() == ('op', '-'):
            self.next()
            neg = True
        p = self.parse_term()
        if neg:
            p = pmul(p, {(): {-1: -1.0}})
        while self.peek()[0] == 'op' and self.peek()[1] in '+-':
            op = self.next()[1]
            q = self.parse_term()
            if op == '-':
                q = pmul(q, {(): {-1: -1.0}})
            p = padd(p, q)
        return p

    def parse_term(self):
        p = self.parse_factor()
        while self.peek() == ('op', '*'):
            self.next()
            p = pmul(p, self.parse_factor())
        return p

    def parse_factor(self):
        kind, val = self.next()
        if kind == 'num':
            return {(): {-1: val}}
        if kind == 'op' and val == '(':
            p = self.parse_expr()
            assert self.next() == ('op', ')')
            return p
        if kind == 'name':
            if val in ('a', 'x', 'df'):
                ik, iv = self.next()
                assert ik == 'idx'
                if val == 'a':
                    return {(): {iv: 1.0}}
                if val == 'x':
                    return {((iv, 1),): {-1: 1.0}}
                return self.env['df', iv]
            return self.env[val]
        raise ValueError('unexpected token %r %r' % (kind, val))


def extract(path):
    with open(path) as f:
        text = f.read()
    # strip comments and the function wrapper; keep statements
    text = re.sub(r'/\*.*?\*/', '', text, flags=re.S)
    text = re.sub(r'//[^\n]*', '', text)
    stmts = [s.strip().lstrip('{}').strip() for s in text.split(';')]

    assigns = []   # (lhs_key, rhs_string) in order
    ret_expr = None
    for s in stmts:
        # the assignment always sits at the end of the chunk (any preamble such
        # as the function signature or brace precedes it)
        m = re.search(r'const\s+double\s+(t[0-9]+)\s*=\s*(.*)\Z', s, re.S)
        if m:
            assigns.append((m.group(1), m.group(2)))
            continue
        m = re.search(r'(?:\A|[\s{])df\[([0-9]+)\]\s*=\s*(.*)\Z', s, re.S)
        if m:
            assigns.append((('df', int(m.group(1))), m.group(2)))
            continue
        m = re.search(r'(?:\A|[\s{])return\s+(.*)\Z', s, re.S)
        if m:
            ret_expr = m.group(1)
    assert ret_expr is not None

    # reachability from the return expression
    tok_cache = {}
    def deps(rhs):
        toks = tokenize(rhs)
        tok_cache[id(rhs)] = toks
        out = set()
        i = 0
        while i < len(toks):
            k, v = toks[i]
            if k == 'name' and v.startswith('t') and v[1:].isdigit():
                out.add(v)
            elif k == 'name' and v == 'df':
                out.add(('df', toks[i + 1][1]))
                i += 1
            i += 1
        return toks, out

    rhs_by_key = dict(assigns)
    ret_toks, needed = deps(ret_expr)
    frontier = set(needed)
    all_deps = {}
    while frontier:
        key = frontier.pop()
        if key in all_deps:
            continue
        toks, d = deps(rhs_by_key[key])
        all_deps[key] = (toks, d)
        frontier.update(d - set(all_deps))

    env = {}
    n_eval = 0
    for key, rhs in assigns:
        if key not in all_deps:
            continue
        toks = all_deps[key][0]
        env[key] = Parser(toks, env).parse_expr()
        n_eval += 1
    energy = Parser(ret_toks, env).parse_expr()
    print('  %s: evaluated %d/%d reachable assignments, %d monomials'
          % (os.path.basename(path), n_eval, len(assigns), len(energy)))
    return energy


def to_arrays(energy, nvars, a):
    """Flatten the symbolic polynomial, contract with fit vector a."""
    rows_e, rows_c = [], []
    raw_aidx, raw_w, raw_mono = [], [], []
    for mono, lin in sorted(energy.items()):
        e = np.zeros(nvars, np.int8)
        for var, ex in mono:
            e[var] = ex
        c = 0.0
        for k, w in lin.items():
            c += w * (1.0 if k == -1 else a[k])
            raw_aidx.append(k)
            raw_w.append(w)
            raw_mono.append(len(rows_c))
        rows_e.append(e)
        rows_c.append(c)
    E = np.array(rows_e, np.int8)
    c = np.array(rows_c, np.float64)
    keep = c != 0.0
    return (E[keep], c[keep],
            np.array(raw_mono, np.int32), np.array(raw_aidx, np.int32),
            np.array(raw_w, np.float64))


def compile_oracle(path, symbol, na, nx, is_cpp_namespace):
    with tempfile.TemporaryDirectory() as td:
        hdr2 = os.path.join(td, 'poly-2b-v6x.h')
        hdr3 = os.path.join(td, 'poly-3b-v2x.h')
        with open(hdr2, 'w') as f:
            f.write('extern "C" double poly_2b_v6x_eval(const double a[1153], const double x[31], double g[31]);\n')
        with open(hdr3, 'w') as f:
            f.write('namespace poly_3b_v2x { double eval(const double a[1163], const double x[36], double g[36]); }\n'
                    'extern "C" double poly_3b_v2x_eval_c(const double* a, const double* x, double* g);\n')
        so = os.path.join(td, 'poly.so')
        # copy the source into td so our stub headers win the quoted-include search
        local_src = os.path.join(td, os.path.basename(path))
        with open(path) as fin, open(local_src, 'w') as fout:
            fout.write(fin.read())
        srcs = [local_src]
        if is_cpp_namespace:
            shim = os.path.join(td, 'shim.cpp')
            with open(shim, 'w') as f:
                f.write('#include "poly-3b-v2x.h"\n'
                        'extern "C" double poly_3b_v2x_eval_c(const double* a, const double* x, double* g)'
                        '{ return poly_3b_v2x::eval(a, x, g); }\n')
            srcs.append(shim)
        subprocess.run(['g++', '-O0', '-shared', '-fPIC', '-I', td, '-o', so] + srcs,
                       check=True)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.POINTER(ctypes.c_double)] * 3

        def call(a, x):
            g = np.zeros(len(x))
            e = fn(a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   g.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            return e, g

        rng = np.random.default_rng(0)
        return [(x := rng.uniform(0.05, 0.9, size=nx), call(np.asarray(ARGS_A), x))
                for _ in range(24)]


ARGS_A = None


def eval_data_form(E, c, x):
    mono = np.prod(np.power(x[None, :], E.astype(np.float64)), axis=1)
    e = float(mono @ c)
    g = ((mono * c)[None, :] @ (E.astype(np.float64) / np.where(x == 0, 1, x)[None, :])).ravel()
    return e, g


def main():
    global ARGS_A
    ap = argparse.ArgumentParser()
    ap.add_argument('--reference', default='/root/reference')
    ap.add_argument('--out', default=os.path.join(os.path.dirname(__file__), '..',
                                                  'mbpol_openmm_plugin_tpu', 'data'))
    args = ap.parse_args()
    src = os.path.join(args.reference, 'platforms', 'reference', 'src')

    jobs = [
        ('poly-2b-v6x.cpp', 'poly_2b_v6x_eval', 1153, 31, False,
         'twobody_constants.npz', 'poly2b.npz'),
        ('poly-3b-v2x.cpp', 'poly_3b_v2x_eval_c', 1163, 36, True,
         'threebody_constants.npz', 'poly3b.npz'),
    ]
    for fname, symbol, na, nx, shim, constname, outname in jobs:
        path = os.path.join(src, fname)
        print('extracting', fname)
        energy = extract(path)
        a = np.load(os.path.join(args.out, constname))['thefit']
        assert a.shape == (na,)
        ARGS_A = a
        E, c, raw_mono, raw_aidx, raw_w = to_arrays(energy, nx, a)
        print('  %d monomials (nonzero), max degree %d' % (len(c), E.sum(1).max()))

        print('  compiling oracle & validating...')
        samples = compile_oracle(path, symbol, na, nx, shim)
        max_rel = 0.0
        for x, (e_ref, g_ref) in samples:
            e, g = eval_data_form(E, c, x)
            max_rel = max(max_rel, abs(e - e_ref) / max(1e-30, abs(e_ref)))
            gerr = np.max(np.abs(g - g_ref) / np.maximum(1e-30, np.abs(g_ref)))
            max_rel = max(max_rel, gerr)
        print('  max relative error vs compiled reference: %.3e' % max_rel)
        assert max_rel < 1e-9, max_rel
        np.savez_compressed(os.path.join(args.out, outname),
                            exponents=E, coeffs=c,
                            raw_mono=raw_mono, raw_aidx=raw_aidx, raw_w=raw_w)
        print('  wrote', outname)


if __name__ == '__main__':
    main()
