"""Float64 NumPy oracle of one PCISPH step.

A deliberately slow, loop-free-of-cleverness transcription of the reference's
physics in its original scaled-SI formulation (citations per function point
into /root/reference/src/sphFluid.cl). Used only by tests to validate the
nondimensionalized f32 implementation.
"""
import numpy as np

LIQUID, ELASTIC, BOUNDARY = 1, 2, 3


def exact_neighbors(pos, h, max_n=32):
    """Exact <=max_n nearest neighbors within radius h (sim units)."""
    pos = pos.astype(np.float64)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    nbrs = []
    for i in range(len(pos)):
        cand = np.nonzero(d[i] <= h)[0]
        order = np.argsort(d[i][cand], kind="stable")[:max_n]
        sel = cand[order]
        nbrs.append([(int(j), float(d[i, j])) for j in sel])
    return nbrs


def density(pos, nbrs, p):
    """sphFluid.cl:472-518 — poly6 sum over cached distances, >= h^6 clamp."""
    hs = p.h_s
    rho = np.zeros(len(pos))
    for i, lst in enumerate(nbrs):
        s = 0.0
        for j, r_sim in lst:
            rs = r_sim * p.simulation_scale
            s += (hs * hs - rs * rs) ** 3
        s = max(s, hs**6)
        rho[i] = p.mass * p.w_poly6 * s
    return rho


def external_forces(pos, vel, rho, ptype, normal, nbrs, p):
    """sphFluid.cl:589-708 — viscosity + surface tension + gravity."""
    hs = p.h_s
    st_coef = (
        -1.5e-9 * 0.3 * p.w_poly6 * (hs**2 / 2.0) ** 3 * p.simulation_scale
    )
    del2w = -p.grad_w_spiky
    g = np.array(p.gravity)
    a = np.zeros((len(pos), 3))
    for i, lst in enumerate(nbrs):
        if ptype[i] == BOUNDARY:
            continue
        sum_v = np.zeros(3)
        st = np.zeros(3)
        for j, r_sim in lst:
            rs = r_sim * p.simulation_scale
            if rs < hs:
                # boundary neighbors contribute their wall normal as
                # "velocity" (reference stores normals in the velocity
                # buffer, sphFluid.cl:653 + :860)
                vj = normal[j] if ptype[j] == BOUNDARY else vel[j]
                sum_v += (vj - vel[i]) * (hs - rs) / rho[j]
                st += st_coef * (pos[i] - pos[j])
        a[i] = p.mass * p.viscosity * del2w / rho[i] * sum_v + g + st
    return a


def elastic_forces(a_ext, pos, ptype, springs, activation, p):
    """sphFluid.cl:709-815 — Hooke + muscle contraction on elastic rows.

    springs: list of (i, [(j, rest_scaled, muscle_id), ...]).
    """
    k = 6.0e8
    for i, conns in springs:
        for j, rest, muscle_id in conns:
            d = (pos[i] - pos[j]) * p.simulation_scale
            r = np.linalg.norm(d)
            if r != 0.0:
                a_ext[i] += -(d / r) * (r - rest) * k
                if muscle_id > 0 and activation[muscle_id - 1] > 0:
                    a_ext[i] += -(d / r) * activation[muscle_id - 1] * 800.0
    return a_ext


def pcisph_loop(pos, vel, ptype, nbrs, p):
    """sphFluid.cl:889-1212 — 3 prediction-correction iterations."""
    n = len(pos)
    hs = p.h_s
    pr = np.zeros(n)
    a_p = np.zeros((n, 3))
    boundary = ptype == BOUNDARY
    for _ in range(p.n_pcisph_iters):
        # predict positions: only pressure accel (sphFluid.cl:924)
        v_star = vel + p.time_step * a_p
        x_star = pos + p.time_step * p.simulation_scale_inv * v_star
        x_star[boundary] = pos[boundary]

        # predicted density from predicted positions (cl:982-1059)
        rho_star = np.zeros(n)
        for i, lst in enumerate(nbrs):
            s = 0.0
            for j, _ in lst:
                dv = (x_star[i] - x_star[j]) * p.simulation_scale
                r2 = float(dv @ dv)
                if r2 < hs * hs:
                    s += (hs * hs - r2) ** 3
            s = max(s, hs**6)
            rho_star[i] = p.mass * p.w_poly6 * s

        # pressure correction — ALL particles (cl:1084-1086 commented out)
        pr = pr + np.maximum(0.0, (rho_star - p.rho0) * p.delta)

        # pressure force (cl:1101-1212)
        a_p = np.zeros((n, 3))
        for i, lst in enumerate(nbrs):
            if boundary[i]:
                continue
            f = np.zeros(3)
            for j, r_sim in lst:
                rs = r_sim * p.simulation_scale
                if rs < hs and rs > 0.0:
                    if rs < 0.25 * hs:
                        val = (
                            -((0.25 * hs - rs) ** 2)
                            * 0.5
                            * (p.rho0 * p.delta)
                            / rho_star[j]
                        )
                    else:
                        val = (
                            -((hs - rs) ** 2)
                            * 0.5
                            * (pr[i] + pr[j])
                            / rho_star[j]
                        )
                    vr = (pos[i] - pos[j]) * p.simulation_scale
                    f += val * vr / rs
            a_p[i] = f * p.mass * p.grad_w_spiky / rho_star[i]
    return pr, a_p


def boundary_interaction(x_new, v_new, pos0, ptype, normal, nbrs_i, p):
    """sphFluid.cl:824-887 for one particle; returns corrected (x, v)."""
    r0 = p.r0
    n_ci = np.zeros(3)
    w_sum = 0.0
    w2_sum = 0.0
    for j, _ in nbrs_i:
        if ptype[j] == BOUNDARY:
            dist = np.linalg.norm(x_new - pos0[j])
            w = max(0.0, (r0 - dist) / r0)
            n_ci += normal[j] * w
            w_sum += w
            w2_sum += w * (r0 - dist)
    ln = np.linalg.norm(n_ci)
    if ln != 0.0:
        x_new = x_new + (n_ci / ln) * w2_sum / w_sum
        vn = float(n_ci @ v_new)
        if vn < 0:
            v_new = (v_new - n_ci * vn) * 0.99
    return x_new, v_new


def integrate(pos, vel, ptype, normal, a_ext, a_p, nbrs, p):
    """sphFluid.cl:1684-1808."""
    out_pos = pos.copy()
    out_vel = vel.copy()
    lo = np.array(p.box_min)
    hi = np.array(p.box_max) - 1e-6
    for i in range(len(pos)):
        if ptype[i] == BOUNDARY:
            continue
        a = a_ext[i] + a_p[i]
        v_new = vel[i] + p.time_step * a
        x_new = pos[i] + p.time_step * p.simulation_scale_inv * v_new
        x_new = np.clip(x_new, lo, hi)
        v_avg = (vel[i] + v_new) * 0.5
        x_new, v_avg = boundary_interaction(
            x_new, v_avg, pos, ptype, normal, nbrs[i], p
        )
        out_pos[i] = x_new
        out_vel[i] = v_avg
    return out_pos, out_vel


def _project_to_plane(ps, pa, pb, pc):
    """sphFluid.cl:1250-1308 calculateProjectionOfPointToPlane — Cramer
    solve of [n; ab; ac] x = [n.pa; ab.ps; ac.ps] where n = ab x ac.
    Returns (proj, ok); ok=False when the determinant is exactly zero
    (degenerate triangle — the reference printf's and RETURNS, aborting
    the whole particle's membrane pass)."""
    ab = pb - pa
    ac = pc - pa
    n = np.cross(ab, ac)
    A = np.stack([n, ab, ac])
    b = np.array([float(n @ pa), float(ab @ ps), float(ac @ ps)])
    det = np.linalg.det(A)
    if det == 0.0:
        return ps, False
    return np.linalg.solve(A, b), True


def membrane_interaction(pos_new, ptype, nbrs, tris, particle_tris, p,
                         z_zeroed=True, abort_on_degenerate=True):
    """sphFluid.cl:1369-1682 (LIVE path only) — post-integration membrane
    position correction for liquid particles.

    Transcribed semantics (the commented-out blocks — the in-triangle
    test cl:1513-1533, the membrane-side back-reaction cl:1617-1637, the
    velocity averaging cl:1610-1615 — are dead code and excluded):
      * only LIQUID rows interact (cl:1393-1395); geometry is read from
        the CURRENT (post-integrate) positions while the neighbor list is
        the one built at step start (cl:1428 neighborMap);
      * per elastic neighbor jd: average of normalize(x_i - proj(x_i))
        over jd's valid membrane triangles (cl:1466-1546), where proj is
        the Cramer plane projection;
      * the particle-to-neighbor DISTANCE zeroes the z component first
        (cl:1439-1440 "mv change from subscripting" — pass
        ``z_zeroed=False`` for the engine's documented 3D-distance
        deviation);
      * Ihmsen position projection (cl:1576-1605): w = max(0,(r0-d)/r0),
        delta = normalize(sum n_jd w) * sum(w (r0-d)) / sum(w);
      * degenerate triangles / exactly-in-plane particles make the
        reference RETURN for that particle (cl:1468-1472, 1501-1505) —
        pass ``abort_on_degenerate=False`` for the engine's documented
        masking deviation.

    nbrs: step-start neighbor lists (exact_neighbors). tris: [M,3] global
    particle ids. particle_tris: [n,slots] triangle ids per particle
    (-1-terminated, reference particleMembranesList). Returns positions.
    """
    out = pos_new.copy().astype(np.float64)
    pos = pos_new.astype(np.float64)
    r0 = p.r0
    for i in range(len(pos)):
        if ptype[i] != LIQUID:
            continue
        entries = []  # (n_avg, dist)
        aborted = False
        for jd, _ in nbrs[i]:
            if ptype[jd] != ELASTIC:
                continue
            v = pos[i] - pos[jd]
            if z_zeroed:
                v = v.copy()
                v[2] = 0.0
            dist = float(np.sqrt(v @ v))
            n_sum = np.zeros(3)
            ijk = 0
            for t in particle_tris[jd]:
                if t < 0:
                    break  # reference list is -1-terminated (else break)
                a, b, c = (pos[v_] for v_ in tris[t])
                proj, ok = _project_to_plane(pos[i], a, b, c)
                if not ok:
                    if abort_on_degenerate:
                        aborted = True
                        break
                    continue
                nvec = pos[i] - proj
                ln = float(np.linalg.norm(nvec))
                if ln > 0.0:
                    n_sum += nvec / ln
                    ijk += 1
                elif abort_on_degenerate:
                    # cl:1501-1505 "error #001" return
                    aborted = True
                    break
            if aborted:
                break
            if ijk > 0:
                entries.append((n_sum / ijk, dist))
        if aborted or not entries:
            continue
        n_ci = np.zeros(3)
        w_sum = 0.0
        w2_sum = 0.0
        for n_m, dist in entries:
            w = max(0.0, (r0 - dist) / r0)
            n_ci += n_m * w
            w_sum += w
            w2_sum += w * (r0 - dist)
        ln2 = float(n_ci @ n_ci)
        if ln2 != 0.0:
            out[i] = out[i] + (n_ci / np.sqrt(ln2)) * w2_sum / w_sum
    return out


def full_step(pos, vel, ptype, normal, p, springs=None, activation=None,
              membranes=None, **mem_kw):
    """One complete step; returns (pos, vel, diag dict).

    membranes: optional (tris, particle_tris) — applied AFTER integration
    on the updated positions with the step-start neighbor lists
    (reference stage order, owPhysicsFluidSimulator.cpp:108-113)."""
    pos = pos.astype(np.float64)
    vel = vel.astype(np.float64)
    nbrs = exact_neighbors(pos, p.h, p.max_neighbors)
    rho = density(pos, nbrs, p)
    a_ext = external_forces(pos, vel, rho, ptype, normal, nbrs, p)
    if springs:
        a_ext = elastic_forces(
            a_ext, pos, ptype, springs,
            activation if activation is not None else np.zeros(100), p,
        )
    pr, a_p = pcisph_loop(pos, vel, ptype, nbrs, p)
    new_pos, new_vel = integrate(pos, vel, ptype, normal, a_ext, a_p, nbrs, p)
    if membranes is not None:
        tris, particle_tris = membranes
        new_pos = membrane_interaction(
            new_pos, ptype, nbrs, tris, particle_tris, p, **mem_kw
        )
    return new_pos, new_vel, dict(
        rho=rho, a_ext=a_ext, pressure=pr, a_p=a_p, nbrs=nbrs
    )
