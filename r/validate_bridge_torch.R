# One-command proof of the reticulate seam into the PyTorch/CUDA port.
#
# The reference's only process boundary is the mclapply fan-out over design
# rows (vert-cor.R:534-554). r/backend_torch.R swaps that seam for
# dpcorr_torch via reticulate; this script proves the marshalling round
# trip in any environment that has R + reticulate + torch + this repo:
#
#   RETICULATE_PYTHON=$(which python3) Rscript r/validate_bridge_torch.R
#
# (on the CPU by default; DPCORR_TORCH_DEVICE=cuda runs it on the card).
# It runs the fixed 4-point grid TWICE —
#   (a) through reticulate:  run_grid_backend(..., backend = "cuda")
#   (b) through a subprocess: python r/validate_bridge_torch_helper.py,
#       whose output comes back as detail_all.rds via the port's own RDS
#       writer
# — and diffs the two frames cell by cell. Both sides are the identical
# computation (same seeds, same code), so ANY difference is a marshalling
# defect: type coercion, row reordering, precision loss, NA mangling. It
# finishes by pushing the bridge frame through the reference's
# grouped-summary recipe (vert-cor.R:575-597).

# run from the repo root: Rscript r/validate_bridge_torch.R
source(file.path("r", "backend_torch.R"))

DEVICE <- Sys.getenv("DPCORR_TORCH_DEVICE", "cpu")
design_df <- expand.grid(n = c(400L, 800L), rho = c(0.2, 0.6))
design_df <- design_df[order(design_df$n, design_df$rho), ]
design_df$eps1 <- 1.0
design_df$eps2 <- 1.0
B <- 16L
SEED <- 2025L

message("== (a) 4-point grid through reticulate (backend='cuda') ==")
bridge_df <- run_grid_backend(design_df, B = B, seed = SEED,
                              backend = "cuda", py_backend = "bucketed",
                              device = DEVICE)
stopifnot(nrow(bridge_df) == nrow(design_df) * B)

message("== (b) same grid via subprocess -> detail_all.rds ==")
rds_path <- tempfile(fileext = ".rds")
helper <- file.path("r", "validate_bridge_torch_helper.py")
rc <- system2(Sys.getenv("RETICULATE_PYTHON", "python"),
              c(helper, "--out", shQuote(rds_path), "--device", DEVICE))
stopifnot(rc == 0L)
subproc_df <- readRDS(rds_path)

message("== diff ==")
stopifnot(identical(dim(bridge_df), dim(subproc_df)))
# the bridge keeps the reference's column order: same names, same order
stopifnot(identical(names(bridge_df), names(subproc_df)))
max_abs_diff <- 0
for (col in names(bridge_df)) {
  a <- bridge_df[[col]]
  b <- subproc_df[[col]]
  if (is.numeric(a)) {
    # NA placement must agree BEFORE the numeric diff — an NA-vs-value
    # mismatch is exactly the marshalling defect class this script exists
    # to catch, and na.rm would silently drop it
    stopifnot(identical(is.na(a), is.na(b)))
    live <- !is.na(a)
    d <- if (any(live)) {
      max(abs(as.numeric(a[live]) - as.numeric(b[live])))
    } else 0
    max_abs_diff <- max(max_abs_diff, d)
    if (d != 0) message(sprintf("  col %-12s max |diff| = %.3g", col, d))
  } else {
    stopifnot(identical(as.character(a), as.character(b)))
  }
}
stopifnot(max_abs_diff == 0)  # bit-identity: same computation both ways

message("== reference summary recipe on the bridge frame ==")
# vert-cor.R:575-597 shape: grouped coverage / mse by design cell
agg <- aggregate(cbind(ni_cover, int_cover) ~ n + rho_true + eps1 + eps2,
                 data = bridge_df, FUN = mean)
print(agg)
stopifnot(all(agg$ni_cover >= 0 & agg$ni_cover <= 1))

message("BRIDGE VALIDATION PASSED: reticulate round trip is bit-exact")
