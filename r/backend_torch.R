# R front-end for the PyTorch/CUDA port (dpcorr_torch) on an NVIDIA card.
#
# The reference fans its design grid out with parallel::mclapply
# (vert-cor.R:534-554, ver-cor-subG.R:271-296). This shim wraps that exact
# seam with a `backend=` switch, as r/backend.R does for the JAX package:
#
#   source("r/backend_torch.R")
#   detail_all <- run_grid_backend(design_df, run_row_fun, B = 250,
#                                  backend = "cuda")    # or "mclapply"
#
# backend = "mclapply" reproduces the reference behavior verbatim (fork on
# Unix, serial on Windows). backend = "cuda" ships the design rows to
# dpcorr_torch.rbridge via reticulate and returns the same metadata-joined
# replicate-level data.frame the reference builds at vert-cor.R:557-568, so
# downstream data.table summaries and ggplot figures run unchanged.
# device = NULL runs on the card (and stops when there is none);
# device = "cpu" runs on the CPU.
#
# What R receives: the bridge returns a dict of numpy columns, which
# reticulate makes a named list (in the dict's column order) and
# as.data.frame a data.frame. reticulate converts numpy int64 arrays to R
# doubles (R has no 64-bit integer type), so `repl` and `n` arrive as
# numeric, not integer; r/backend.R's pandas frame holds the same int64
# columns and arrives the same way. The f32 detail columns and the f64
# design columns arrive as doubles, as there.
#
# Requires: install.packages("reticulate"); a Python env with torch and this
# repository on PYTHONPATH (reticulate::use_python(...) or
# RETICULATE_PYTHON).

run_grid_backend <- function(design_df, run_row_fun = NULL, B = 250,
                             seed = 2025,
                             backend = c("cuda", "mclapply"),
                             dgp = "gaussian", use_subG = FALSE,
                             alpha = 0.05, normalise = TRUE,
                             py_backend = "bucketed",
                             fused = "off",
                             bucket_merge = "off",
                             device = NULL,
                             mc_cores = max(1L, parallel::detectCores() - 1L)) {
  backend <- match.arg(backend)

  if (backend == "mclapply") {
    # The reference's own path (vert-cor.R:513-554), unchanged.
    stopifnot(is.function(run_row_fun))
    runner <- if (.Platform$OS.type == "windows") {
      function(i) run_row_fun(design_df[i, ], seed = 1e6 + i)
    } else {
      NULL
    }
    results <- if (.Platform$OS.type == "windows") {
      lapply(seq_len(nrow(design_df)), runner)
    } else {
      parallel::mclapply(seq_len(nrow(design_df)), function(i) {
        run_row_fun(design_df[i, ], seed = 1e6 + i)
      }, mc.cores = mc_cores)
    }
    return(results)
  }

  # backend == "cuda": one call across the whole grid; replications run as
  # tensors on the card instead of forked across host cores.
  if (!requireNamespace("reticulate", quietly = TRUE)) {
    stop("backend='cuda' needs the reticulate package")
  }
  bridge <- reticulate::import("dpcorr_torch.rbridge")
  rows <- lapply(seq_len(nrow(design_df)), function(i) {
    as.list(design_df[i, c("n", "rho", "eps1", "eps2")])
  })
  # py_backend = "bucketed" is the grid fast path (one call per (n, eps)
  # bucket); "local" and "sharded" run one row at a time; all three are
  # bit-identical per point. fused = "auto" additionally runs each eligible
  # bucket through one launch of the fused CUDA kernel (another PRNG stream
  # family; statistically identical). bucket_merge = "eps" merges subG
  # buckets across eps-pairs (one call per n; statistically identical).
  detail <- bridge$run_design_rows(rows, b = as.integer(B),
                                   seed = as.integer(seed), dgp = dgp,
                                   use_subg = use_subG, alpha = alpha,
                                   normalise = normalise,
                                   backend = py_backend,
                                   fused = fused,
                                   bucket_merge = bucket_merge,
                                   device = device)
  as.data.frame(detail)
}

# HRS eps-sweep through the same backend (real-data-sims.R:342-448 seam).
run_hrs_sweep_backend <- function(eps_grid = seq(0.25, 2.5, by = 0.1),
                                  R = 200, seed = 2025, device = NULL,
                                  panel_path = NULL) {
  bridge <- reticulate::import("dpcorr_torch.rbridge")
  as.data.frame(bridge$run_hrs_sweep(eps_grid, reps = as.integer(R),
                                     seed = as.integer(seed),
                                     device = device,
                                     panel_path = panel_path))
}
